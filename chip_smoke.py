#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jumbo_mae_tpu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. device — the card's name and power limit (nvidia-smi) and PyTorch's name;
2. build  — every kernel of ``jumbo_mae_tpu_tpu_torch/csrc`` with nvcc
   (sm_90a), in parallel, with the ptxas register/spill report;
3. K1 vs plain — the flash-attention forward kernel against its plain
   PyTorch version on the card, ``o`` and ``lse``: float32 (TF32 off) at
   atol/rtol 1e-5 (sum order), bfloat16 on the same bf16 inputs at atol
   2e-2, at the training slice's MAE encoder and decoder shapes, the
   serving shapes (ViT-B/16 at 224 px and batch 64, 448 px, the
   MAE-visible 52-token length, ViT-H/14 with head_dim 80, head_dims 32
   and 128), every tile edge of the wgmma kernel (S = 64, 65, 128, 129,
   257 around its 64-row tiles; S = 1, 8, 9, 16, 17, 32, 33 where its
   shape rule packs 16, 8, 4, 2 or 1 heads per tile; the ring hop
   512x13x16x64; head_dims 32, 80, 128 at short and ragged lengths) and
   Sq != Sk both ways, packed and not; two bf16 runs bit-identical; plus
   strided q/k/v views of a fused projection;
4. K2/K3 vs plain — the backward kernels (dq and D; dk and dv) against
   the plain backward at the MAE encoder and decoder shapes of the
   training slice, ViT-B, 448 px, ViT-H/14 and a ragged head_dim-128
   shape, and at every tile and packing edge of the wgmma kernels
   (``BWD_SHAPES``, the ring hop among them) and K1's Sq != Sk cases,
   without and with a random lse cotangent: float32 (TF32 off) at
   atol/rtol 1e-4, bfloat16 within 3e-2 of the largest reference entry;
   the D that K2 writes against ``attention_delta`` within 1e-5 of
   max(1, max|D|); two runs bit-identical; strided views of a fused
   projection and broadcast dO, k and v equal to contiguous copies; pad
   rows and columns inert (NaN beyond the sequence in q, k, v, dO and O is
   never read), packed tiles included; K2 and K3 keep their blocks per SM;
5. kernel timings — K1 at the main path's four shapes (ViT-B/16
   serving; the MAE decoder, encoder and ring hop with lse) and 448 px,
   with the wrapper's host µs per call; K2 (which computes D) and K3 at
   the MAE encoder and decoder shapes and the ring hop, K2 + K3 against
   SDPA's backward, the standalone D pass (``attention_delta``, the cost
   K2 took over) beside them; ``FlashAttention`` forward + backward
   against SDPA's; for each kernel its plain version and one PyTorch
   library call (scaled_dot_product_attention, forward or backward; a
   yardstick the port never calls), beside the least time the card could
   take. Every time is device ms per call from CUDA-graph replay (the
   wrapper's host time exceeds the kernel's, so eager launches would time
   the host), each kernel's eager back-to-back time beside it;
6. the serving slice — the ViT-B/16 classifier as
   recipes/finetune_vit_b16.yaml builds it (12 layers, dim 768, 3 CLS
   tokens, sincos2d, 1000 labels, bf16 compute, random weights from a
   seed) served through ``InferenceEngine`` (logits, features cls and gap;
   requests of 1, 5, 64 and 70 images) and through ``cli.predict``:
   shapes, finite values, kernel launches = 12 x dispatches, padding
   inertness, the float32 engine on the card against the float32 engine
   on the CPU, images/s;
7. the training slice — one MAE pretraining step of ViT-L/16 as
   recipes/pretrain_vit_l16_in1k_800ep.yaml builds it (24 layers, dim
   1024, mask 0.75, sincos2d, grad_ckpt; decoder 8 x 512 x 16 heads;
   norm_pix_loss; bf16 compute; AdamW with bf16 mu; random weights from a
   seed) at batch 128 through ``create_state`` + ``make_train_step`` on
   ``synthetic_batches``: 3 warm-up and 10 timed steps on one repeated
   batch; the kernels' launch counts, no call of the plain D pass, a
   finite loss that falls, step ms, images/s, MFU and peak memory; then
   preset vit_t16 (head_dim 16, which no kernel takes) served and trained
   as it is, ``attn_impl="auto"`` taking the einsum path;
8. float32 step, card against CPU — ViT-L widths at 2 encoder layers and
   1 decoder layer, batch 2, the same weights and mask noise: loss, every
   gradient and every parameter's change in one AdamW step;
9. K4 vs plain — ``flash_attention_with_lse`` (K1 writing lse; K2 and K3
   with D shifted by the lse cotangent) against its plain version, o, lse,
   dq, dk and dv under random cotangents of both outputs, at the ring hop
   shape of the training slice and at long-context hop shapes, float32
   and bfloat16 at the K1/K2/K3 gates; the plain version against torch
   autograd of an f32 (o, logsumexp) reference; K4's times;
10. ring op — ``StackedRing`` (the seq axis held in one process) with the
   flash inner, n = 2 and 4, against full attention on the card, forward
   and gradients; K4 and K1 launches grow by n per call; the einsum inner
   at the decoder shape with n = 4;
11. the sequence-parallel slice — the ViT-L/16 MAE step of phase 7 with
   ring attention on a seq = 4 one-process mesh (encoder on the flash
   ring: every hop one K4 call at (4·128, 13, 16, 64); decoder on the
   einsum ring, 199 tokens padded to 200), through ``create_state`` +
   ``make_train_step`` under ``set_mesh``: 3 warm-up and 10 timed steps,
   launch counts derived from layers × hops × passes, no call of the plain
   D pass, a falling loss, step ms, images/s, MFU and peak memory; then one float32 step at ViT-L
   widths and reduced depth, ring against no ring on the card, loss and
   every gradient within 1e-3 of scale;
12. image backends — which of cv2, PIL and torchvision import here, and
   the decode and resize backends the port's data path takes;
13. the driver — ViT-L/16 MAE pretraining from
   recipes/pretrain_vit_l16_in1k_800ep.yaml through ``cli.train.main`` in
   this process (batch 128, 0.75 epochs of 1024 toy images = 6 steps,
   warmup 0, 4 data workers, wandb off), on toy tar shards at 224 px
   written here first (1024 train, 256 valid, 256 a shard): launch counts
   set to 0 just before and read just after (K1 = 56 and K2 = K3 = 32 per
   train step, K1 = 32 per eval batch), every loss finite, a ``val/loss``
   in the metrics JSONL, the first batch not the synthetic one, a
   committed ``ckpt/last``; images/s through the CLI, the host's wait for
   batches and its time in the train-step call, the save's blocking and
   writing seconds and bytes, the step against phase 7's;
14. resume at full width — 3 steps, then ``run.resume=true`` to 6, in a
   second output directory, against phase 13's 6 straight steps: the
   per-step digests of the host batches identical, the state restored at
   step 3 equal to the state saved there bit for bit, the losses of steps
   4-6 equal (their relative differences logged); whether one step
   repeats exactly from the same state with and without
   ``torch.use_deterministic_algorithms``;
15. a ViT-B/16 MAE save — 2 steps of
   recipes/pretrain_vit_b16_in1k_1600ep.yaml through ``cli.train.main``
   (batch 128, 4 workers) on phase 13's shards, ending in ``ckpt/last``;
16. finetuning — recipes/finetune_vit_b16.yaml as written (RandAugment,
   Mixup/CutMix, label smoothing, droppath, AdamW with layer decay)
   warm-started from phase 15's save through ``cli.train.main`` (batch
   256 train and eval, 6 steps, warmup 0, 4 workers): the merge loads
   every trunk parameter, keeps the head fresh and drops the decoder;
   K1 = K2 = K3 = 12 a train step and K1 = 12 an eval batch; finite
   losses; ``val/acc1``/``val/acc5`` in the JSONL; a committed ``best``;
   ``run.eval_only`` from ``best`` reproduces the evaluation exactly;
   images/s, MFU, the loader wait and the step's host time; then one
   float32 classify step (ViT-B widths, 2 layers, mixup and CutMix
   pinned) on the card against the CPU: loss and gradients within 1e-3
   of scale, the AdamW + layer-decay step against the CPU's;
17. linear probing — recipes/linear_lars_vit_l16.yaml warm-started from
   phase 13's ViT-L/16 save (batch 256, 6 steps): K1 = 24 and
   K2 = K3 = 0 a step, every trunk parameter bit-unchanged under LARS,
   the head and the BatchNorm statistics moved, finite losses,
   ``val/acc1`` in the JSONL;
18. the toy proof (ROADMAP A4's gate) — tests/test_learning_e2e.py's toy
   MAE pretraining (600 steps) and GAP linear probes (400 steps) from it
   and from a random init, through ``cli.train.main`` on 32 px toy
   shards written here, in a fresh process with PyTorch's default
   settings: the pretrained probe above the random one by 0.1 and by
   1.5x, and above 0.25.

Phases 3-5 hold K1-K3 at the finetune shape (256, 199, 12, 64) too, with
NaN past the sequence inert, and time them there against SDPA.

The ring's process-group transport (``ProcessGroupRing`` under NCCL) is
not run here: NCCL takes one GPU per rank, and this runs on one card.

Before the last line it prints the ``{"kernels": [...]}`` line and the
nvidia-smi line; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

VIT_B_SHAPE = (64, 199, 12, 64)  # ViT-B/16 at 224 px, batch 64
# the finetune slice: ViT-B/16 at 224 px (196 patches + 3 CLS) at its batch 256
FT_SHAPE = (256, 199, 12, 64)
# the training slice: MAE encoder (49 visible + 3 CLS) and decoder (196 + 3)
# of the ViT-L/16 recipe at batch 128
ENC_SHAPE = (128, 52, 16, 64)
DEC_SHAPE = (128, 199, 16, 32)
KERNEL_SHAPES = [
    ENC_SHAPE,
    DEC_SHAPE,
    VIT_B_SHAPE,
    FT_SHAPE,
    (4, 787, 16, 64),  # ViT-L/16 at 448 px
    (8, 52, 16, 64),  # 49 visible patches + 3 CLS (MAE, mask 0.75)
    (4, 259, 16, 80),  # ViT-H/14 at 224 px
    (8, 199, 8, 32),  # head_dim 32
    (2, 331, 8, 128),  # head_dim 128
    # K1's tile edges. Rows and keys around the 64-row tiles: 64/65,
    # 128/129, 257. The shape rule packs 2^p heads of a batch row into one
    # 64-row tile while 64 / 2^(p+1) >= max(Sq, Sk) and 2^p < H: at H = 16,
    # 16 heads for 1-4 positions, 8 for 5-8, 4 for 9-16 (the 13-token ring
    # hop), 2 for 17-32 and 1 from 33 on, so S = 1, 8/9, 16/17, 32/33 sit
    # on its edges. Head_dims 32, 80 and 128 at short and ragged lengths,
    # with H = 12 and 6 leaving the last packed tile part empty.
    (8, 1, 16, 64),
    (4, 8, 16, 64),
    (4, 9, 16, 64),
    (8, 13, 16, 64),
    (4, 16, 16, 64),
    (4, 17, 16, 64),
    (4, 32, 16, 64),
    (4, 33, 16, 64),
    (4, 64, 8, 64),
    (4, 65, 8, 64),
    (2, 128, 8, 64),
    (2, 129, 8, 64),
    (2, 257, 4, 64),
    (512, 13, 16, 64),
    (3, 13, 12, 32),
    (2, 129, 4, 32),
    (2, 13, 4, 80),
    (2, 65, 4, 128),
    (2, 13, 6, 128),
]
# K1 with Sq != Sk, (q shape, Sk): one tile per head both ways (and one
# query row against 65 keys at head_dim 128); packed
# tiles with Sq > Sk (4 and 8 heads, the second 8 of H = 12 part empty)
# and Sq < Sk (2 heads)
CROSS_SHAPES = [
    ((2, 40, 4, 64), 130),
    ((4, 13, 16, 64), 52),
    ((2, 199, 4, 32), 7),
    ((4, 13, 16, 64), 7),
    ((4, 1, 16, 64), 20),
    ((2, 5, 12, 32), 3),
    ((2, 1, 8, 128), 65),
]
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
REQUESTS = (1, 5, 64, 70)
# the sequence-parallel slice: a seq axis of 4 cuts the 52 encoder tokens
# into 4 shards of 13; one K4 call per hop over the 4 shards of batch 128
SEQ = 4
HOP_SHAPE = (SEQ * 128, 52 // SEQ, 16, 64)
K4_SHAPES = [HOP_SHAPE, (4, 1024, 16, 64), (2, 787, 16, 80), (2, 331, 8, 128)]
RING_SHAPES = [ENC_SHAPE, (2, 4096, 16, 64)]
# K2/K3 shapes: the training slice's, ViT-B, 448 px, ViT-H/14 (head_dim 80,
# which keeps the mma.sync kernels), head_dim 128; then every tile edge of
# the wgmma kernels, which tile and pack as K1 does: rows and keys around
# the 64-row tiles (64/65, 128/129); S = 1, 8/9, 13, 16/17, 32/33 at H = 16
# on the edges of the heads-per-tile rule (16, 8, 4, 2, 1 heads), with
# H = 12 and 6 leaving the last packed tile part empty; the ring hop;
# head_dims 32 and 128 packed and ragged. Sq != Sk: K1's CROSS_SHAPES.
BWD_SHAPES = [
    ENC_SHAPE,
    DEC_SHAPE,
    VIT_B_SHAPE,
    FT_SHAPE,
    (4, 787, 16, 64),
    (4, 259, 16, 80),
    (2, 331, 8, 128),
    (8, 1, 16, 64),
    (4, 8, 16, 64),
    (4, 9, 16, 64),
    (8, 13, 16, 64),
    (4, 16, 16, 64),
    (4, 17, 16, 64),
    (4, 32, 16, 64),
    (4, 33, 16, 64),
    (4, 64, 8, 64),
    (4, 65, 8, 64),
    (2, 128, 8, 64),
    (2, 129, 8, 64),
    HOP_SHAPE,
    (3, 13, 12, 32),
    (2, 9, 6, 64),
    (2, 1, 16, 32),
    (2, 129, 4, 32),
    (2, 13, 4, 80),
    (2, 17, 16, 128),
    (2, 65, 4, 128),
    (2, 13, 6, 128),
]


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


def build_kernels(_build, names: list[str] | None = None) -> float:
    """Phase 2: build the kernel sources (default all) in parallel, log
    ptxas's registers and spills per kernel, fail on any spill. Returns
    the seconds the build took."""
    t0 = time.perf_counter()
    reports = _build.build(names)
    dt = time.perf_counter() - t0
    log(f"build: {len(names or _build.sources())} kernel source(s) in {dt:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {name}: {line.strip()}")
        spills = [ln for ln in rep.splitlines() if "spill stores" in ln]
        check(all(" 0 bytes spill stores" in ln and " 0 bytes spill loads" in ln for ln in spills),
              f"{name}: ptxas reports register spills")
    return dt


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


def attention_bound_ms(shape, dtype_bytes: int, peak_flops: float, lse: bool = False) -> tuple[float, str]:
    """Least time for softmax(q·kᵀ)·v at (B, S, H, D): 4·B·H·S²·D
    operations over the peak rate, or q, k, v read once and o (and, with
    ``lse``, the f32 lse per row) written once over the memory rate,
    whichever is larger."""
    b, s, h, d = shape
    t_ops = 4 * b * h * s * s * d / peak_flops
    t_bytes = (4 * b * s * h * d * dtype_bytes + (4 * b * h * s if lse else 0)) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def qkv(shape, dtype, seed: int, sk: int | None = None):
    """q (B, S, H, D) scaled by head_dim**-0.5, and k, v of ``sk`` keys
    (default S), from a seeded generator on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    b, s, h, d = shape
    q = torch.randn(shape, generator=g, device="cuda")
    k, v = (torch.randn((b, s if sk is None else sk, h, d), generator=g, device="cuda") for _ in range(2))
    return (q * d**-0.5).to(dtype), k.to(dtype), v.to(dtype)


def phase_kernels(fa) -> dict:
    """Phase 3: kernel against plain version, every shape, both dtypes."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    cases = [(shape, None) for shape in KERNEL_SHAPES] + CROSS_SHAPES
    for dtype, tol in ((torch.float32, dict(atol=1e-5, rtol=1e-5)), (torch.bfloat16, dict(atol=2e-2, rtol=0.0))):
        for i, (shape, sk) in enumerate(cases):
            q, k, v = qkv(shape, dtype, seed=i, sk=sk)
            o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
            torch.cuda.synchronize()
            ref_o, ref_lse = fa.flash_attention_fwd_plain(q, k, v, with_lse=True)
            e_o = (o.float() - ref_o.float()).abs().max().item()
            e_l = (lse - ref_lse).abs().max().item()
            name = str(dtype).split(".")[-1]
            line = f"kernel {name} {shape} sk {k.shape[1]}: max|o-plain| {e_o:.3e}  max|lse-plain| {e_l:.3e}"
            check(torch.isfinite(o.float()).all().item(), f"non-finite kernel output at {shape} {name}")
            torch.testing.assert_close(o, ref_o, **tol)
            torch.testing.assert_close(lse, ref_lse, **tol)
            if dtype == torch.bfloat16:  # no atomics: a second run is bit-identical
                o2, lse2 = fa.flash_attention_fwd(q, k, v, with_lse=True)
                same = torch.equal(o, o2) and torch.equal(lse, lse2)
                check(same, f"two bf16 runs of K1 differ at {shape} sk {k.shape[1]}")
                line += "; rerun bit-identical"
            log(line)
            errs[(name, shape, k.shape[1])] = max(e_o, e_l)
    # strided inputs: q, k, v as views of one fused (B, S, 3, H, D) projection
    b, s, h, d = VIT_B_SHAPE
    fused = torch.randn((b, s, 3, h, d), device="cuda").to(torch.bfloat16)
    q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
    o = fa.flash_attention_fwd(q, k, v)
    ref = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    check(torch.equal(o, ref), "strided q/k/v views disagree with contiguous copies")
    log("kernel on strided q/k/v views equals contiguous copies: True")
    # pad rows are inert at the finetune shape: NaN stored past the 199
    # tokens in the same buffers is never read
    q, k, v = qkv(FT_SHAPE, torch.bfloat16, seed=77)
    ref, ref_lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    padded = []
    for x in (q, k, v):
        buf = torch.full((FT_SHAPE[0], FT_SHAPE[1] + 57, *FT_SHAPE[2:]), float("nan"), dtype=x.dtype, device="cuda")
        buf[:, : FT_SHAPE[1]] = x
        padded.append(buf[:, : FT_SHAPE[1]])
    o, lse = fa.flash_attention_fwd(*padded, with_lse=True)
    check(torch.equal(o, ref) and torch.equal(lse, ref_lse), f"pad rows change K1's output at {FT_SHAPE}")
    log(f"kernel at {FT_SHAPE} with NaN past the sequence equals the contiguous run: True")
    return errs


def graph_ms(fn, per_graph: int = 20, reps: int = 20) -> float:
    """Device ms per call of ``fn``: ``per_graph`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events. Where the
    wrapper's host time (~30 µs) exceeds the kernel's, back-to-back eager
    launches leave the card idle between them and time the host; a replay
    sends the captured launches back to back."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    for _ in range(3):
        graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * per_graph)


def host_us(fn, calls: int = 1000) -> float:
    """Host µs per call of ``fn``: ``time.perf_counter`` over ``calls``
    calls without a sync (after 50 warm-up calls)."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def phase_timings(fa) -> dict:
    """Phase 5a: K1 in bf16 at the main paths' shapes (ViT-B serving; the
    MAE decoder and encoder, the ring hop and the finetune batch, with lse,
    as training calls it) and at 448 px: device time per call from CUDA-graph replay
    (``ms``, the plain version, SDPA's forward) and from eager back-to-back
    launches (``eager_ms``, the method of the earlier kernels lines), the
    least time the card could take, and the wrapper's host µs per call;
    K1 in f32 at the ViT-B shape."""
    import torch
    import torch.nn.functional as F

    out = {}
    shapes = ((VIT_B_SHAPE, False), (DEC_SHAPE, True), (ENC_SHAPE, True), (HOP_SHAPE, True),
              ((4, 787, 16, 64), False), (FT_SHAPE, True))
    for shape, lse in shapes:
        q, k, v = qkv(shape, torch.bfloat16, seed=100)

        def k1():
            return fa.flash_attention_fwd(q, k, v, with_lse=lse)

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D) views
        ms, eager = graph_ms(k1), cuda_ms(k1, iters=200, warmup=20)
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0))
        plain_ms = graph_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, with_lse=lse), per_graph=5, reps=10)
        bound, by = attention_bound_ms(shape, 2, PEAK_BF16_FLOPS, lse=lse)
        host = host_us(k1)
        out[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                          eager_ms=eager, host_us=host)
        log(
            f"timing K1 bf16 {shape}{' with lse' if lse else ''}: kernel {ms:.4f} ms (eager back to back "
            f"{eager:.4f} ms), plain {plain_ms:.4f} ms, sdpa forward {lib_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}), kernel at {100 * bound / ms:.1f}% of bound; host {host:.2f} us per call"
        )
    q, k, v = qkv(VIT_B_SHAPE, torch.float32, seed=101)
    ms = graph_ms(lambda: fa.flash_attention_fwd(q, k, v), per_graph=5, reps=5)
    bound, by = attention_bound_ms(VIT_B_SHAPE, 4, PEAK_F32_FLOPS)
    log(f"timing f32 {VIT_B_SHAPE}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return out


def bwd_bound_ms(shape, products: int, tensors: int, rows: int) -> tuple[float, str]:
    """Least time for one backward kernel in bf16 at (B, S, H, D):
    ``products`` matrix products of 2·B·H·S²·D operations over the peak
    rate, or ``tensors`` (B, S, H, D) bf16 tensors and ``rows`` f32 values
    per row each read or written once over the memory rate. K2 does 3
    products, reads q, k, v, dO, O and lse (and K4's g_lse) and writes dq
    and D: 6 tensors and 2 rows (3 with g_lse); K3 does 4, reads q, k, v,
    dO, lse and D and writes dk and dv: 6 tensors and 2 rows."""
    b, s, h, d = shape
    t_ops = products * 2 * b * h * s * s * d / PEAK_BF16_FLOPS
    t_bytes = (tensors * b * s * h * d * 2 + rows * b * h * s * 4) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def bwd_inputs(shape, dtype, seed: int, fa, sk: int | None = None):
    """q, k, v (``sk`` keys, default S), dO on the card and the forward's o
    and lse (kernel K1)."""
    import torch

    q, k, v = qkv(shape, dtype, seed, sk=sk)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn(shape, generator=g, device="cuda").to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    return q, k, v, do, o, lse


def folds_delta(fa) -> bool:
    """Whether the package's K2 computes D itself (this checkout) or takes
    it from the plain D pass (an older checkout, as
    scripts/torch_k1_bench.py --base loads one)."""
    return "g_lse" in inspect.signature(fa.flash_attention_bwd).parameters


def kernel_bwd(fa, q, k, v, o, lse, do, g_lse=None):
    """(dq, dk, dv) through the kernels, with K4's lse cotangent ``g_lse``
    (or none): K2 computes D here; an older checkout's kernels take it from
    the D pass."""
    if folds_delta(fa):
        return fa.flash_attention_bwd(q, k, v, o, lse, do, g_lse=g_lse)
    return fa.flash_attention_bwd(q, k, v, o, lse, do, delta=fa.attention_delta(o, do, g_lse))


@contextlib.contextmanager
def counting_delta_passes(fa):
    """Count the calls of the plain D pass (``attention_delta``) in the
    block: ``with counting_delta_passes(fa) as calls: ...; calls[0]``."""
    calls = [0]
    plain = fa.attention_delta

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    fa.attention_delta = counted
    try:
        yield calls
    finally:
        fa.attention_delta = plain


def check_delta(name: str, got, want) -> float:
    """K2's D against ``attention_delta``: within 1e-5 of max(1, max|D|).
    Both accumulate the row's products in f32 (a bf16 product is exact in
    f32, an f32 one is rounded once, or fused) in another order: K2 each
    quad lane a quarter of the row, then two shuffles; torch its own
    reduction. Returns the error over the scale."""
    import torch

    check(got.shape == want.shape and got.dtype == torch.float32, f"D layout at {name}")
    check(bool(torch.isfinite(got).all()), f"non-finite D at {name}")
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    check(err <= 1e-5 * scale, f"D at {name}: max|K2 − attention_delta| {err:.3e} > 1e-5 x {scale:.3e}")
    return err / scale


def phase_bwd_kernels(fa) -> dict:
    """Phase 4: K2 and K3 against the plain backward, every shape and
    Sq != Sk case, both dtypes, without and with a random lse cotangent;
    K2's D against the plain D pass; determinism, strided and broadcast
    views, inert padding; K2's and K3's blocks per SM."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    folds = folds_delta(fa)
    errs, d_worst = {}, 0.0
    cases = [(shape, None) for shape in BWD_SHAPES] + CROSS_SHAPES
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for i, (shape, sk) in enumerate(cases):
            q, k, v, do, o, lse = bwd_inputs(shape, dtype, 200 + i, fa, sk=sk)
            b, sq, h, _ = shape
            g = torch.Generator(device="cuda").manual_seed(2000 + i)
            for g_lse in (None, torch.randn((b * h, sq), generator=g, device="cuda")):
                case = f"{shape} sk {k.shape[1]} {name}{' g_lse' if g_lse is not None else ''}"
                got = kernel_bwd(fa, q, k, v, o, lse, do, g_lse)
                torch.cuda.synchronize()
                want_d = fa.attention_delta(o, do, g_lse)
                ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, delta=want_d)
                # one key and no lse cotangent: dq and dk are 0 exactly
                grads = check_grads(case, got, ref, dtype, sk=k.shape[1] if g_lse is None else None)
                for gname, (err, _) in grads.items():
                    key = (name, shape, k.shape[1], gname)
                    errs[key] = max(err, errs.get(key, 0.0))
                line = [f"{gname} {err:.3e}/{scale:.3e}" for gname, (err, scale) in grads.items()]
                again = kernel_bwd(fa, q, k, v, o, lse, do, g_lse)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                if folds:  # the D that K2 wrote, from a launch of its own
                    _, d1 = fa.flash_attention_bwd_dq(q, k, v, do, o, lse, g_lse)
                    _, d2 = fa.flash_attention_bwd_dq(q, k, v, do, o, lse, g_lse)
                    same = same and torch.equal(d1, d2)
                    d_err = check_delta(case, d1, want_d)
                    d_worst = max(d_worst, d_err)
                    line.append(f"D {d_err:.3e} of max(1, |D|)")
                check(same, f"two runs of K2/K3 differ at {case}")
                log(f"K2/K3 {case}: max|err|/max|ref| {', '.join(line)}; rerun bit-identical {same}")
    if folds:
        log(f"K2's D against attention_delta at every case, both dtypes, with and without g_lse: worst "
            f"{d_worst:.3e} of max(1, max|D|) (gate 1e-5)")

    b, s, h, d = VIT_B_SHAPE
    fused = torch.randn((b, s, 5, h, d), device="cuda").to(torch.bfloat16)
    q, k, v, do, o_view = (fused[:, :, i] for i in range(5))
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    o_view.copy_(o)
    got = kernel_bwd(fa, q, k, v, o_view, lse, do)
    ref = kernel_bwd(fa, *(x.contiguous() for x in (q, k, v, o)), lse, do.contiguous())
    check(all(torch.equal(a, b) for a, b in zip(got, ref)), "K2/K3 on strided views differ from contiguous copies")
    log("K2/K3 on strided q/k/v/dO/O views equal contiguous copies: True")

    # broadcast views (stride 0, which no TMA tensor map describes): dO of
    # o.sum() and k, v shared over the batch give the gradients of their
    # contiguous copies
    for shape in (DEC_SHAPE, HOP_SHAPE, (2, 70, 4, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, o, lse = bwd_inputs(shape, dtype, 350, fa)
            views = {"dO": (q, k, v, do[:1].expand(shape)),
                     "k, v": (q, k[:1].expand(shape), v[:1].expand(shape), do)}
            for what, (qb, kb, vb, dob) in views.items():
                o, lse = fa.flash_attention_fwd(qb.contiguous(), kb.contiguous(), vb.contiguous(), with_lse=True)
                got = kernel_bwd(fa, qb, kb, vb, o, lse, dob)
                ref = kernel_bwd(fa, *(x.contiguous() for x in (qb, kb, vb)), o, lse, dob.contiguous())
                check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                      f"K2/K3 with broadcast {what} differ from contiguous copies at {shape} {dtype}")
    log("K2/K3 on broadcast dO and k, v views equal contiguous copies: True")

    # pad rows and columns are inert: NaN stored past the sequence in the
    # same buffers (q, k, v, dO and O) is never read (a read would turn the
    # gradients or D NaN)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 199, 4, 64), (8, 199, 12, 64), (3, 70, 2, 128), (2, 52, 4, 32), (4, 13, 16, 64),
                      (2, 9, 12, 32)):
            q, k, v, do, o, lse = bwd_inputs(shape, dtype, 300, fa)
            g_lse = torch.randn((shape[0] * shape[2], shape[1]), device="cuda")
            ref = kernel_bwd(fa, q, k, v, o, lse, do, g_lse)
            padded = []
            for x in (q, k, v, do, o):
                buf = torch.full((shape[0], shape[1] + 61, *shape[2:]), float("nan"), dtype=dtype, device="cuda")
                buf[:, : shape[1]] = x
                padded.append(buf[:, : shape[1]])
            pq, pk, pv, pdo, po = padded
            got = kernel_bwd(fa, pq, pk, pv, po, lse, pdo, g_lse)
            check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"pad rows/columns change the gradients at {shape}")
            if folds:
                d_pad = fa.flash_attention_bwd_dq(pq, pk, pv, pdo, po, lse, g_lse)[1]
                d_ref = fa.flash_attention_bwd_dq(q, k, v, do, o, lse, g_lse)[1]
                check(torch.equal(d_pad, d_ref), f"pad rows change K2's D at {shape}")
    log("K2/K3 pad rows and columns inert (NaN past the sequence in q, k, v, dO and O never read): True")

    if hasattr(fa, "blocks_per_sm"):
        # the O tile K2 loads for D must not cost a resident block: the
        # blocks an SM holds, against the register bound each kernel is
        # built for (BwdTile<D>::kMinBlocksDq / kMinBlocksDkv)
        want = {("K2", 32): 5, ("K2", 64): 3, ("K2", 128): 1, ("K3", 32): 4, ("K3", 64): 3, ("K3", 128): 1}
        held = {key: fa.blocks_per_sm(*key) for key in want}
        log("blocks per SM (bf16 wgmma kernels): " + ", ".join(
            f"{kern} at head_dim {d} {n} (built for {want[(kern, d)]})" for (kern, d), n in held.items()))
        check(all(held[key] >= n for key, n in want.items()), f"a backward kernel lost a block per SM: {held}")
    return errs


def attention_fb_bound_ms(shape, g_lse: bool = False) -> tuple[float, str]:
    """Least time for attention's forward and then its backward in bf16 at
    (B, S, H, D), as two calls: the forward reads q, k, v and writes o and
    lse; the backward reads q, k, v, o, dO and lse (and K4's g_lse) and
    writes dq, dk and dv: 12 tensors and 2 (3) f32 values per row over the
    memory rate, or 2 + 5 products of 2·B·H·S²·D operations over the peak
    rate."""
    b, s, h, d = shape
    t_bytes = (12 * b * s * h * d * 2 + (3 if g_lse else 2) * b * h * s * 4) / PEAK_BYTES
    t_ops = 14 * b * h * s * s * d / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_bwd_timings(fa, k1_timings: dict | None = None) -> dict:
    """Phase 5b: K2 and K3 at the MAE encoder and decoder shapes, the ring
    hop and the finetune batch, bf16: each kernel (K2 computing D), the plain backward (all
    three gradients), SDPA's backward as (forward + backward) − forward,
    which computes its own D, so K2 + K3 stands against it; the standalone
    D pass (``attention_delta``, which K2's D replaced and an older
    checkout still runs first) beside them; and at the MAE and finetune
    shapes ``FlashAttention`` (K1 + K2 + K3 through autograd) forward + backward
    against SDPA's and the einsum path's. Device ms per call from
    CUDA-graph replay, as phase 5a; each kernel's eager back-to-back time
    beside it. The einsum comparison needs ``k1_timings`` (phase 5a's
    result) and is left out without it."""
    import torch
    import torch.nn.functional as F

    k1_timings = k1_timings or {}
    folds = folds_delta(fa)

    def einsum_path(q, k, v):  # models/layers.py's einsum branch
        probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k).float(), dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    out = {}
    for shape in (ENC_SHAPE, DEC_SHAPE, HOP_SHAPE, FT_SHAPE):
        q, k, v, do, o, lse = bwd_inputs(shape, torch.bfloat16, 400, fa)
        if folds:
            def k2_call():
                return fa.flash_attention_bwd_dq(q, k, v, do, o, lse)

            dd = k2_call()[1]
        else:  # an older checkout: K2 reads the D pass's output
            dd = fa.attention_delta(o, do)

            def k2_call():
                return fa.flash_attention_bwd_dq(q, k, v, do, lse, dd)

        def k3_call():
            return fa.flash_attention_bwd_dkv(q, k, v, do, lse, dd)

        k2, k3 = graph_ms(k2_call), graph_ms(k3_call)
        eager = {"K2": cuda_ms(k2_call), "K3": cuda_ms(k3_call)}
        plain = graph_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, delta=dd), per_graph=5, reps=10)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2)
        fwd = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0))
        both = graph_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, scale=1.0), (qt, kt, vt), dot))
        lib = max(both - fwd, 0.0)
        # the D pass: reads o and dO, writes one f32 per row
        b, sq, h, d = shape
        d_ms = graph_ms(lambda: fa.attention_delta(o, do))
        d_bound = (2 * b * sq * h * d * 2 + b * h * sq * 4) / PEAK_BYTES * 1e3
        out[("D", shape)] = dict(ms=d_ms, bound_ms=d_bound, bound_by="bytes")
        bwd_ms = k2 + k3 + (0.0 if folds else d_ms)
        out[("backward", shape)] = dict(ms=bwd_ms, library_ms=lib)
        what = "K2 (with D) + K3" if folds else "D pass + K2 + K3"
        log(f"timing backward bf16 {shape}: {what} {bwd_ms:.4f} ms against sdpa backward {lib:.4f} ms "
            f"({bwd_ms / lib:.2f}x); the standalone D pass (attention_delta) {d_ms:.4f} ms, bound "
            f"{d_bound:.4f} ms (bytes)")
        if shape in (ENC_SHAPE, DEC_SHAPE, FT_SHAPE):
            # FlashAttention (the counterpart of pallas_flash_attention):
            # forward + backward through autograd, against SDPA's
            from jumbo_mae_tpu_tpu_torch.ops.flash_attention import flash_attention

            qa, ka, va = (x.detach().requires_grad_() for x in (q, k, v))
            fb = graph_ms(lambda: torch.autograd.grad(flash_attention(qa, ka, va), (qa, ka, va), do))
            fb_plain = graph_ms(lambda: torch.autograd.grad(
                fa.flash_attention_fwd_plain(qa, ka, va), (qa, ka, va), do), per_graph=5, reps=10)
            bound, by = attention_fb_bound_ms(shape)
            out[("FlashAttention", shape)] = dict(ms=fb, plain_ms=fb_plain, library_ms=both, bound_ms=bound,
                                                  bound_by=by, eager_ms=cuda_ms(lambda: torch.autograd.grad(
                                                      flash_attention(qa, ka, va), (qa, ka, va), do)))
            log(f"timing FlashAttention bf16 {shape} forward + backward: {fb:.4f} ms against sdpa forward + "
                f"backward {both:.4f} ms ({fb / both:.2f}x), plain {fb_plain:.4f} ms, bound {bound:.4f} ms "
                f"({by}), at {100 * bound / fb:.1f}% of bound")
        if shape in k1_timings:
            # attn_impl="auto" in training: the kernels' forward (K1's time
            # from phase 5a) and backward against the einsum path's (bf16
            # scores, f32 softmax, bf16 probs), all by graph replay
            k1 = k1_timings[shape]["ms"]
            qe, ke, ve = (x.detach().requires_grad_() for x in (q, k, v))
            einsum = graph_ms(lambda: torch.autograd.grad(einsum_path(qe, ke, ve), (qe, ke, ve), do),
                              per_graph=5, reps=10)
            log(f"training attention bf16 {shape}: K1 + {what} {k1 + bwd_ms:.4f} ms, einsum "
                f"forward and backward {einsum:.4f} ms")
            out[("einsum", shape)] = dict(kernels_ms=k1 + bwd_ms, einsum_ms=einsum)
        # K2 reads O beside q, k, v, dO and writes D (an older K2 read D)
        for name, ms, products, tensors in (("K2", k2, 3, 6 if folds else 5), ("K3", k3, 4, 6)):
            bound, by = bwd_bound_ms(shape, products, tensors, 2)
            out[(name, shape)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                                      eager_ms=eager[name])
            log(f"timing {name} bf16 {shape}: kernel {ms:.4f} ms (eager back to back {eager[name]:.4f} ms), "
                f"plain backward {plain:.4f} ms, "
                f"sdpa backward {lib:.4f} ms, bound {bound:.4f} ms ({by}), kernel at "
                f"{100 * bound / ms:.1f}% of bound")
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


def vit_l16_mae():
    """recipes/pretrain_vit_l16_in1k_800ep.yaml's model and optimizer,
    built in code (the GPU machine has no PyYAML): warmup 0 and a long
    cosine, so the 13 steps run near the peak learning rate."""
    from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig

    enc = preset("vit_l16", labels=None, mask_ratio=0.75, posemb="sincos2d", grad_ckpt=True)
    dec = DecoderConfig(layers=8, dim=512, heads=16)
    opt = OptimConfig(name="adamw", learning_rate=1.5e-4, lr_scaling="batch", b1=0.9, b2=0.95,
                      weight_decay=0.05, mu_dtype="bfloat16", warmup_steps=0, training_steps=10_000)
    return enc, dec, opt


TRAIN_BATCH = 128
WARMUP_STEPS, TIMED_STEPS = 3, 10


def phase_train(fa, smi: str) -> dict:
    """Phase 7: the ViT-L/16 MAE pretraining step at batch 128, bf16."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
    from jumbo_mae_tpu_tpu_torch.obs.mfu import H100_PEAK_BF16_TFLOPS, mfu, pretrain_flops_per_image
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step

    enc, dec, opt = vit_l16_mae()
    t0 = time.perf_counter()
    state = create_state((enc, dec, True), opt, device="cuda", init_seed=0, rng_seed=0,
                         global_batch_size=TRAIN_BATCH)
    nparams = sum(p.numel() for p in state.model.parameters())
    log(f"train state built in {time.perf_counter() - t0:.2f} s: {nparams} params, encoder seq "
        f"{enc.num_cls_tokens + enc.keep_len}, decoder seq {enc.num_cls_tokens + enc.num_patches}, "
        f"peak lr {opt.peak_lr(TRAIN_BATCH):.3e}")
    step = make_train_step(mode="pretrain")
    batch = next(synthetic_batches(TRAIN_BATCH, enc.image_size, seed=0, distinct=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts set to 0 just before, read just after
    fa.LAUNCHES = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = 0
    losses = []
    with counting_delta_passes(fa) as delta_passes:
        for _ in range(WARMUP_STEPS):
            state, m = step(state, batch)
            losses.append(m["loss"])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        start.record()
        for _ in range(TIMED_STEPS):
            state, m = step(state, batch)
            losses.append(m["loss"])
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t_host
    counts = {"K1": fa.LAUNCHES, "K2": fa.LAUNCHES_BWD_DQ, "K3": fa.LAUNCHES_BWD_DKV}
    log(f"main path: the plain D pass (attention_delta) ran {delta_passes[0]} times (K2 computes D)")
    check(delta_passes[0] == 0, "the backward ran the plain D pass on the card")

    steps = WARMUP_STEPS + TIMED_STEPS
    # every attention call's backward runs K2 then K3 once: one call per
    # encoder and decoder block. K1 runs in every forward, and again in the
    # gradient-checkpoint recompute of every encoder block (the decoder is
    # not checkpointed): per step K2 = K3 = 24 + 8 = 32, K1 = 2·24 + 8 = 56
    want_bwd = enc.layers + dec.layers
    want_fwd = (2 if enc.grad_ckpt else 1) * enc.layers + (2 if dec.grad_ckpt else 1) * dec.layers
    log(f"main path: {steps} steps, launches K1 {counts['K1']} (want {steps} x {want_fwd}), "
        f"K2 {counts['K2']} and K3 {counts['K3']} (want {steps} x {want_bwd})")
    check(counts["K2"] == counts["K3"] == steps * want_bwd, "K2/K3 launches per step")
    check(counts["K1"] == steps * want_fwd, "K1 launches per step")

    vals = [x.item() for x in losses]
    check(all(np.isfinite(vals)), f"non-finite loss: {vals}")
    log("loss per step: " + ", ".join(f"{x:.5f}" for x in vals))
    check(vals[-1] < vals[0] and np.mean(vals[-3:]) < np.mean(vals[:3]), "the loss does not fall over the steps")
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    ips = TRAIN_BATCH * 1e3 / step_ms
    flops = pretrain_flops_per_image(enc, dec)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    util = mfu(ips, flops)
    log(f"train step: {step_ms:.2f} ms (CUDA events over {TIMED_STEPS} steps; host clock "
        f"{host_s / TIMED_STEPS * 1e3:.2f} ms), {ips:.1f} images/s, {flops / 1e9:.1f} GFLOP/image, "
        f"MFU {100 * util:.2f}% of {H100_PEAK_BF16_TFLOPS:.0f} TFLOP/s, peak memory {peak_gib:.2f} GiB "
        f"on {smi}")
    return dict(counts=counts, step_ms=step_ms, images_per_s=ips, mfu=util, peak_gib=peak_gib)


def phase_train_f32_vs_cpu() -> None:
    """Phase 8: one float32 step on the card against the same step on the
    CPU: ViT-L widths, 2 encoder layers, 1 decoder layer, batch 2, the
    same weights (seeded CPU init) and the same injected mask noise. Both
    run the flash path: the kernels on the card, their plain versions on
    the CPU. The card's AdamW step is held against the CPU's AdamW applied
    to the card's gradients, so a wrong or skipped update shows even where
    the step is far below the parameter's scale."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
    from jumbo_mae_tpu_tpu_torch.train.optim import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    enc, dec, opt = vit_l16_mae()
    enc = enc.replace(layers=2, dtype="float32", attn_impl="flash")
    dec = dec.replace(layers=1, dtype="float32", attn_impl="flash")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8))
    noise = torch.from_numpy(rng.random(enc.num_patches).astype(np.float32))

    def adamw_step(model, grads: list) -> tuple[dict, dict, float]:
        """One AdamW step from ``grads``: the parameters after it and their
        change, on the CPU (p_after − p_before is exact: the two are within
        a factor 2), and the step's learning rate."""
        tx = make_optimizer(opt, global_batch_size=2)
        state = tx.init(model)
        params = list(model.parameters())
        before = [p.detach().cpu().clone() for p in params]
        tx.update(state, params, grads)
        after = {n: p.detach().cpu() for n, p in model.named_parameters()}
        return after, {n: a - b for (n, a), b in zip(after.items(), before)}, state.learning_rate

    res = {}
    for device in ("cuda", "cpu"):
        model = MAEPretrainModel(enc, dec, True, device=device, seed=0).train()
        out = model(images.to(device), mask_noise=noise.to(device))
        out["loss"].backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        res[device] = (out["loss"].item(), grads, *adamw_step(model, [p.grad for p in model.parameters()]))
    (lg, gg, pg, sg, lr), (lc, gc, pc, sc, _) = res["cuda"], res["cpu"]
    log(f"f32 step cuda vs CPU: loss {lg:.7f} vs {lc:.7f}")
    np.testing.assert_allclose(lg, lc, rtol=1e-3)
    worst = 0.0
    gmax = max(g.abs().max().item() for g in gc.values())
    for n in gc:
        scale = gc[n].abs().max().item()
        err = (gg[n] - gc[n]).abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        # 1e-3 of the gradient's scale (two layers of f32 sums in another
        # order), with a floor of 1e-6 of the largest gradient for tensors
        # whose true gradient is zero (an attention key bias shifts every
        # score of a query alike, so both devices return round-off there)
        check(err <= 1e-3 * scale + 1e-6 * gmax, f"gradient {n}: max diff {err:.3e} vs scale {scale:.3e}")

    flipped = 0
    for n in pc:
        scale = pc[n].abs().max().item()
        diff = (pg[n] - pc[n]).abs()
        # 1e-3 of the parameter's scale. Adam's first step moves an entry by
        # lr·g/|g|: where the gradient is a near-cancelled sum its sign may
        # differ between devices, moving that entry by at most 2·lr(1 + wd|p|)
        over = diff > 1e-3 * scale
        flipped += int(over.sum())
        check(bool((diff[over] <= 2 * lr * (1 + opt.weight_decay * pc[n].abs()[over]) + 1e-3 * scale).all()),
              f"parameter {n} after one AdamW step: max diff {diff.max().item():.3e}")
    total = sum(p.numel() for p in pc.values())
    check(flipped <= max(10, 1e-4 * total), f"{flipped} parameter entries off by more than 1e-3 of scale")

    # The step (about lr = 1e-6 here) is far below 1e-3 of a weight's
    # scale, so the check above cannot see it: hold the card's step against
    # the CPU's AdamW applied to the card's gradients from the same weights
    replay = MAEPretrainModel(enc, dec, True, device="cpu", seed=0).train()
    after, want, _ = adamw_step(replay, [gg[n] for n, _ in replay.named_parameters()])
    worst_step = 0.0
    for n, got in sg.items():
        scale = want[n].abs().max().item()
        # 1e-3 of the step's scale, plus one unit in the last place of the
        # parameter: each device rounds p + step to float32 on its own
        mag = after[n].abs() + want[n].abs()
        ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
        diff = (got - want[n]).abs()
        worst_step = max(worst_step, (diff - ulp).max().item() / max(scale, 1e-30))
        check(bool((diff <= 1e-3 * scale + ulp).all()),
              f"parameter {n}: the card's AdamW step differs from the CPU's on the same gradients "
              f"by {diff.max().item():.3e} (step scale {scale:.3e})")
    log(f"f32 step cuda vs CPU: every gradient within 1e-3 of its scale (worst {worst:.2e}, floor "
        f"{1e-6 * gmax:.2e}); params after one AdamW step within 1e-3 of their scale except {flipped} "
        f"of {total} entries (sign flips of near-zero gradients, each within 2 lr); the card's step "
        f"equals the CPU's AdamW on the card's gradients within 1e-3 of the step's scale and one ulp "
        f"(worst {worst_step:.2e})")


def phase_auto_head_dims(fa) -> None:
    """Preset vit_t16 as it is (head_dim 16, which no kernel takes), served
    through ``InferenceEngine`` and trained two steps through
    ``create_state`` + ``make_train_step``, with a decoder at head_dim 256
    (the recipes' ``dec_heads=2``): ``attn_impl="auto"`` takes the einsum
    path there, so nothing raises and no kernel launches; outputs and the
    loss are finite."""
    import numpy as np

    from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
    from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step

    cfg = preset("vit_t16", image_size=32, patch_size=4, labels=10, posemb="sincos2d")
    engine = InferenceEngine(cfg, max_batch=8, device="cuda")
    images = np.random.default_rng(0).integers(0, 256, (11, 32, 32, 3), dtype=np.uint8)
    fa.LAUNCHES = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = 0
    logits = engine.logits(images)
    check(logits.shape == (11, 10) and bool(np.isfinite(logits).all()), "vit_t16 logits")
    enc = preset("vit_t16", labels=None, mask_ratio=0.75, image_size=64, patch_size=8, posemb="sincos2d",
                 grad_ckpt=True)
    dec = DecoderConfig(layers=1, dim=512, heads=2)
    state = create_state((enc, dec, True), OptimConfig(warmup_steps=0, training_steps=10), device="cuda",
                         global_batch_size=4)
    step, batches = make_train_step(), synthetic_batches(4, 64, distinct=1)
    losses = []
    for _ in range(2):
        state, m = step(state, next(batches))
        losses.append(m["loss"].item())
    counts = (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
    check(bool(np.isfinite(losses).all()), f"vit_t16 losses {losses}")
    check(counts == (0, 0, 0), f"head_dims 16 and 256 launched kernels {counts}")
    log(f"auto at head_dims 16 and 256 (vit_t16 as it is, dec_heads=2): served 11 images and trained 2 steps "
        f"(losses {losses[0]:.5f}, {losses[1]:.5f}) on the einsum path, 0 kernel launches")


def with_grads(fn, xs, cotangents):
    """The outputs of ``fn(*xs)`` (one tensor or a tuple) and the gradients
    of xs under ``cotangents``, from fresh leaves."""
    import torch

    leaves = [x.detach().requires_grad_() for x in xs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, leaves, cotangents)
    return [o.detach() for o in outs] + list(grads)


def reference_with_lse(q, k, v):
    """(o, logsumexp) in float32 by plain torch ops, for autograd."""
    import torch

    b, s, h, _ = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v.float())
    return o, torch.logsumexp(scores, -1).reshape(b * h, s)


def k4_inputs(shape, dtype, seed: int):
    """q, k, v and random cotangents of o (q's dtype) and lse (f32)."""
    import torch

    q, k, v = qkv(shape, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    b, s, h, _ = shape
    g_o = torch.randn(shape, generator=g, device="cuda").to(dtype)
    g_lse = torch.randn((b * h, s), generator=g, device="cuda")
    return (q, k, v), (g_o, g_lse)


def check_grads(name: str, got, ref, dtype, sk: int | None = None) -> dict:
    """K2/K3's gates on (dq, dk, dv): f32 atol/rtol 1e-4 (the same
    arithmetic summed in another order), bf16 within 3e-2 of the largest
    reference entry (P and dS are rounded to bf16 before their products,
    as the Pallas kernels do; the plain version keeps f32). With one key
    (``sk == 1``, passed only without an lse cotangent) the softmax has no
    gradient: dq and dk are 0 exactly, and the kernel's and the plain
    version's values are both f32 rounding of dP − D, so there they are
    held to the f32 gate in bf16 too.
    Returns {gradient: (max abs error, max abs reference)}."""
    import torch

    out = {}
    for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
        check(g.dtype == r.dtype == dtype and g.shape == r.shape, f"{name} {gname}: {g.dtype} {tuple(g.shape)}")
        check(bool(torch.isfinite(g.float()).all()), f"non-finite {gname} at {name}")
        err = (g.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4, msg=f"{name} {gname}")
        elif sk == 1 and gname != "dv":
            check(err <= 1e-4, f"bf16 {gname} at {name} (one key, exactly 0): {err:.3e} > 1e-4")
        else:
            check(err <= 3e-2 * scale, f"bf16 {gname} at {name}: {err:.3e} > 3e-2 x {scale:.3e}")
        out[gname] = (err, scale)
    return out


def phase_k4(fa) -> dict:
    """Phase 9: K4 against its plain version, with random cotangents of
    both outputs, at every K4 shape in both dtypes; the plain version
    against torch autograd of an f32 (o, logsumexp) reference."""
    import torch

    from jumbo_mae_tpu_tpu_torch.ops.flash_attention import flash_attention_with_lse

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for dtype, tol in ((torch.float32, dict(atol=1e-5, rtol=1e-5)), (torch.bfloat16, dict(atol=2e-2, rtol=0.0))):
        name = str(dtype).split(".")[-1]
        for i, shape in enumerate(K4_SHAPES):
            xs, cots = k4_inputs(shape, dtype, 500 + i)
            got = with_grads(flash_attention_with_lse, xs, cots)
            torch.cuda.synchronize()
            ref = with_grads(fa.flash_attention_with_lse_plain, xs, cots)
            e_o = (got[0].float() - ref[0].float()).abs().max().item()
            e_l = (got[1] - ref[1]).abs().max().item()
            check(got[1].dtype == torch.float32 and got[1].shape == (shape[0] * shape[2], shape[1]), "lse layout")
            torch.testing.assert_close(got[0], ref[0], **tol, msg=f"K4 o {shape} {name}")
            torch.testing.assert_close(got[1], ref[1], **tol, msg=f"K4 lse {shape} {name}")
            e_g = max(err for err, _ in check_grads(f"K4 {shape} {name}", got[2:], ref[2:], dtype).values())
            errs[(name, shape)] = max(e_o, e_l, e_g)
            line = f"K4 {name} {shape}: max|err| o {e_o:.3e}, lse {e_l:.3e}, dq/dk/dv {e_g:.3e}"
            if dtype == torch.float32:
                # the plain backward itself, against autograd of the reference
                auto = with_grads(reference_with_lse, xs, cots)
                for what, a, b in zip(("o", "lse", "dq", "dk", "dv"), ref, auto):
                    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=f"plain vs autograd {what} {shape}")
                line += "; plain = autograd of (o, logsumexp) within 1e-4"
            log(line)
    return errs


def phase_k4_timing(fa) -> dict:
    """K4's forward + backward (with g_lse) at the hop shape, bf16: the
    kernels, the plain version and the library's flash attention with
    logsumexp (whose backward takes no lse cotangent), beside the bound;
    device ms per call from CUDA-graph replay, and the kernels' eager
    back-to-back time."""
    import torch

    (q, k, v), (g_o, g_lse) = k4_inputs(HOP_SHAPE, torch.bfloat16, 700)

    def kernels():  # K1 with lse, then K2 (D − g_lse inside) and K3
        o, lse = fa.flash_attention_with_lse_fwd(q, k, v)
        return kernel_bwd(fa, q, k, v, o, lse, g_o, g_lse)

    def plain():
        o, lse = fa.flash_attention_fwd_plain(q, k, v, with_lse=True)
        return fa.flash_attention_bwd_plain(q, k, v, o, lse, g_o, delta=fa.attention_delta(o, g_o, g_lse))

    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, g_o))  # (B, H, S, D) views

    def library():
        o, lse, cq, ck, mq, mk, seed, off, _ = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, False, False, scale=1.0)
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dot, qt, kt, vt, o, lse, cq, ck, mq, mk, 0.0, False, seed, off, scale=1.0)

    ms, eager = graph_ms(kernels), cuda_ms(kernels)
    plain_ms = graph_ms(plain, per_graph=5, reps=10)
    try:
        lib_ms = graph_ms(library)
    except (RuntimeError, TypeError) as exc:  # the yardstick only; the port never calls it
        log(f"K4 library yardstick unavailable: {exc}")
        lib_ms = None
    bound, by = attention_fb_bound_ms(HOP_SHAPE, g_lse=True)
    lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"timing K4 bf16 {HOP_SHAPE} forward + backward with g_lse: kernels {ms:.4f} ms (eager back to back "
        f"{eager:.4f} ms), plain {plain_ms:.4f} "
        f"ms, aten flash attention with logsumexp + its backward (no g_lse) {lib_txt}, bound {bound:.4f} ms "
        f"({by}), kernels at {100 * bound / ms:.1f}% of bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by, eager_ms=eager)


def full_attention(q, k, v):
    """Full attention in float32, the ring's reference."""
    import torch

    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.float())


def phase_ring_op(fa) -> None:
    """Phase 10: StackedRing with the flash inner (n = 2, 4) and with the
    einsum inner (n = 4, decoder shape) against full attention on the
    card, forward and gradients, f32 and bf16; launches per call; times."""
    import torch

    from jumbo_mae_tpu_tpu_torch.ops.flash_attention import flash_attention
    from jumbo_mae_tpu_tpu_torch.parallel import MeshConfig, StackedRing, create_mesh, ring_attention
    from jumbo_mae_tpu_tpu_torch.parallel import ring_self_attention

    torch.backends.cuda.matmul.allow_tf32 = False

    def compare(name, got, ref, dtype):
        for what, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
            err = (g.float() - r.float()).abs().max().item()
            scale = r.float().abs().max().item()
            check(bool(torch.isfinite(g.float()).all()), f"non-finite {what} at {name}")
            # f32: the K1–K3 f32 gates widened to 1e-4 for the n-way lse
            # merge; bf16: within 3e-2 of the largest entry (the K2/K3 gate)
            limit = 1e-4 * (1 + scale) if dtype == torch.float32 else 3e-2 * scale
            check(err <= limit, f"{name} {what}: max|err| {err:.3e} > {limit:.3e}")
        log(f"{name}: out and dq/dk/dv within the {str(dtype).split('.')[-1]} gate of full attention")

    for dtype in (torch.float32, torch.bfloat16):
        for i, shape in enumerate(RING_SHAPES):
            (q, k, v), (g_o, _) = k4_inputs(shape, dtype, 800 + i)
            ref = with_grads(full_attention, (q, k, v), (g_o.float(),))
            ref = [ref[0]] + [g.to(dtype) for g in ref[1:]]
            for n in (2, 4):
                ring = StackedRing(n)

                def run(q, k, v):
                    return ring.unshard(ring_attention(*(ring.shard(x) for x in (q, k, v)), ring=ring, inner="flash"))

                before = (fa.LAUNCHES_WITH_LSE, fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
                got = with_grads(run, (q, k, v), (g_o,))
                torch.cuda.synchronize()
                grew = [a - b for a, b in zip((fa.LAUNCHES_WITH_LSE, fa.LAUNCHES, fa.LAUNCHES_BWD_DQ,
                                               fa.LAUNCHES_BWD_DKV), before)]
                check(grew == [n] * 4, f"ring n={n} launches K4/K1/K2/K3 {grew}, want {n} each")
                compare(f"ring flash n={n} {shape} {str(dtype).split('.')[-1]}", got, ref, dtype)
    # the einsum inner on the decoder's uneven length: 199 padded to 200
    for dtype in (torch.float32, torch.bfloat16):
        (q, k, v), (g_o, _) = k4_inputs(DEC_SHAPE, dtype, 900)
        mesh = create_mesh(MeshConfig(data=1, fsdp=1, seq=SEQ), device="cuda", one_process_seq=True)
        got = with_grads(lambda q, k, v: ring_self_attention(q, k, v, mesh=mesh, inner="einsum"), (q, k, v), (g_o,))
        ref = with_grads(full_attention, (q, k, v), (g_o.float(),))
        compare(f"ring einsum n={SEQ} {DEC_SHAPE} {str(dtype).split('.')[-1]}", got, [ref[0]] + [
            g.to(dtype) for g in ref[1:]], dtype)

    # times, bf16, forward + backward: the flash ring at the encoder shape
    # against flash attention without the ring, and the einsum ring at the
    # decoder shape against the einsum path without it
    from jumbo_mae_tpu_tpu_torch.ops.flash_attention import einsum_attention

    mesh = create_mesh(MeshConfig(data=1, fsdp=1, seq=SEQ), device="cuda", one_process_seq=True)
    for shape, inner, plain in ((ENC_SHAPE, "flash", flash_attention), (DEC_SHAPE, "einsum", einsum_attention)):
        (q, k, v), (g_o, _) = k4_inputs(shape, torch.bfloat16, 950)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        ring_ms = cuda_ms(lambda: torch.autograd.grad(
            ring_self_attention(*leaves, mesh=mesh, inner=inner), leaves, g_o), iters=20)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(plain(*leaves), leaves, g_o), iters=20)
        log(f"timing ring {inner} n={SEQ} bf16 {shape} forward + backward: {ring_ms:.4f} ms; "
            f"without the ring {plain_ms:.4f} ms")


def phase_seq_train(fa, smi: str) -> dict:
    """Phase 11: the ViT-L/16 MAE step with sequence parallelism on a
    one-process seq = 4 mesh, bf16, batch 128."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
    from jumbo_mae_tpu_tpu_torch.obs.mfu import H100_PEAK_BF16_TFLOPS, mfu, pretrain_flops_per_image
    from jumbo_mae_tpu_tpu_torch.parallel import MeshConfig, create_mesh, set_mesh
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step

    enc, dec, opt = vit_l16_mae()
    enc = enc.replace(attn_impl="ring", ring_inner="flash")
    dec = dec.replace(attn_impl="ring", ring_inner="einsum")
    mesh = create_mesh(MeshConfig(data=1, fsdp=1, seq=SEQ), device="cuda", one_process_seq=True)
    batch = next(synthetic_batches(TRAIN_BATCH, enc.image_size, seed=0, distinct=1))
    with set_mesh(mesh):
        state = create_state((enc, dec, True), opt, device="cuda", init_seed=0, rng_seed=0,
                             global_batch_size=TRAIN_BATCH)
        step = make_train_step(mode="pretrain")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: counts set to 0 just before, read just after
        fa.LAUNCHES = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = fa.LAUNCHES_WITH_LSE = 0
        losses = []
        with counting_delta_passes(fa) as delta_passes:
            for _ in range(WARMUP_STEPS):
                state, m = step(state, batch)
                losses.append(m["loss"])
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t_host = time.perf_counter()
            start.record()
            for _ in range(TIMED_STEPS):
                state, m = step(state, batch)
                losses.append(m["loss"])
            end.record()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t_host
    counts = {"K1": fa.LAUNCHES, "K2": fa.LAUNCHES_BWD_DQ, "K3": fa.LAUNCHES_BWD_DKV, "K4": fa.LAUNCHES_WITH_LSE}
    log(f"main path (sequence parallel): the plain D pass ran {delta_passes[0]} times (K2 computes D − g_lse)")
    check(delta_passes[0] == 0, "the ring step's backward ran the plain D pass on the card")

    # a stack on the flash ring makes one K4 call (one K1 launch) per hop
    # in each forward, again in each gradient-checkpoint recompute, and one
    # K2 and K3 launch per hop in the backward; the einsum ring none
    def per_step(cfg, passes: bool) -> int:
        if cfg.attn_impl != "ring" or cfg.ring_inner != "flash":
            return 0
        return cfg.layers * SEQ * ((2 if cfg.grad_ckpt else 1) if passes else 1)

    steps = WARMUP_STEPS + TIMED_STEPS
    want_fwd = per_step(enc, True) + per_step(dec, True)
    want_bwd = per_step(enc, False) + per_step(dec, False)
    log(f"main path (sequence parallel, seq {SEQ}): {steps} steps, launches K4 {counts['K4']} and K1 "
        f"{counts['K1']} (want {steps} x {want_fwd}), K2 {counts['K2']} and K3 {counts['K3']} "
        f"(want {steps} x {want_bwd})")
    check(want_fwd > 0 and counts["K4"] == counts["K1"] == steps * want_fwd, "K4/K1 launches per step")
    check(counts["K2"] == counts["K3"] == steps * want_bwd, "K2/K3 launches per step")

    vals = [x.item() for x in losses]
    check(all(np.isfinite(vals)), f"non-finite loss: {vals}")
    log("loss per step (sequence parallel): " + ", ".join(f"{x:.5f}" for x in vals))
    check(vals[-1] < vals[0] and np.mean(vals[-3:]) < np.mean(vals[:3]), "the loss does not fall over the steps")
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    ips = TRAIN_BATCH * 1e3 / step_ms
    flops = pretrain_flops_per_image(enc, dec)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    util = mfu(ips, flops)
    log(f"sequence-parallel train step: {step_ms:.2f} ms (CUDA events over {TIMED_STEPS} steps; host clock "
        f"{host_s / TIMED_STEPS * 1e3:.2f} ms), {ips:.1f} images/s, {flops / 1e9:.1f} GFLOP/image, "
        f"MFU {100 * util:.2f}% of {H100_PEAK_BF16_TFLOPS:.0f} TFLOP/s, peak memory {peak_gib:.2f} GiB "
        f"on {smi}")
    return dict(counts=counts, step_ms=step_ms, images_per_s=ips, mfu=util, peak_gib=peak_gib)


def phase_ring_f32_vs_plain() -> None:
    """Phase 11b: one float32 step on the card, ring against no ring: ViT-L
    widths, 2 encoder layers and 1 decoder layer (grad_ckpt on), batch 2,
    the same weights and mask noise; the encoder on the flash ring and the
    decoder on the einsum ring of a seq = 4 one-process mesh, against both
    on the flash kernels without a mesh."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
    from jumbo_mae_tpu_tpu_torch.parallel import MeshConfig, create_mesh, set_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    enc, dec, _ = vit_l16_mae()
    enc = enc.replace(layers=2, dtype="float32")
    dec = dec.replace(layers=1, dtype="float32")
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)).cuda()
    noise = torch.from_numpy(rng.random(enc.num_patches).astype(np.float32)).cuda()
    mesh = create_mesh(MeshConfig(data=1, fsdp=1, seq=SEQ), device="cuda", one_process_seq=True)
    res = {}
    for name, e, d, m in (
        ("ring", enc.replace(attn_impl="ring", ring_inner="flash"), dec.replace(attn_impl="ring"), mesh),
        ("plain", enc.replace(attn_impl="flash"), dec.replace(attn_impl="flash"), None),
    ):
        model = MAEPretrainModel(e, d, True, device="cuda", seed=0).train()
        with set_mesh(m):
            out = model(images, mask_noise=noise)
            out["loss"].backward()
        res[name] = (out["loss"].item(), {n: p.grad.detach() for n, p in model.named_parameters()})
    (lr_, gr), (lp, gp) = res["ring"], res["plain"]
    log(f"f32 step ring vs no ring: loss {lr_:.7f} vs {lp:.7f}")
    check(abs(lr_ - lp) <= 1e-3 * abs(lp), "f32 loss: ring against no ring")
    gmax = max(g.abs().max().item() for g in gp.values())
    worst = 0.0
    for n in gp:
        scale = gp[n].abs().max().item()
        err = (gr[n] - gp[n]).abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        # 1e-3 of the gradient's scale, with the floor of phase 8 (1e-6 of
        # the largest gradient) for the attention key biases, whose true
        # gradient is zero
        check(err <= 1e-3 * scale + 1e-6 * gmax, f"gradient {n}: ring vs no ring {err:.3e} vs scale {scale:.3e}")
    log(f"f32 step ring vs no ring: every gradient within 1e-3 of its scale and the floor (largest "
        f"error over scale {worst:.2e}, the zero-gradient key biases included)")


# ---------------------------------------------------------------- the driver

RECIPE = "recipes/pretrain_vit_l16_in1k_800ep.yaml"
# the recipe at batch 128 on 1024 toy images: 0.75 epochs = 6 steps
DRIVER_SETS = ["run.train_batch_size=128", "run.valid_batch_size=128", "data.dataset_size=1024", "run.epochs=0.75",
               "optim.warmup_epochs=0", "data.workers=4", "run.use_wandb=false"]
DRIVER_STEPS = 6


def phase_backends() -> dict:
    """Phase 12: which image packages import here, and the decode and
    resize backends the port's data path takes."""
    import importlib

    from jumbo_mae_tpu_tpu_torch.data import decode, transforms

    found = {}
    for name in ("cv2", "PIL", "torchvision"):
        try:
            mod = importlib.import_module(name)
            found[name] = getattr(mod, "__version__", "?")
        except ImportError:
            found[name] = None
    out = {"packages": found, "decode": decode.backend(), "resize": transforms.backend()}
    log(f"image backends: {json.dumps(out)}")
    check(out["decode"] != "none", "no image decoder (cv2 or PIL) on this machine")
    check(out["resize"] != "none", "no image resizer (cv2 or PIL) on this machine")
    return out


def _digest(images) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(images).tobytes()).hexdigest()[:16]


@contextlib.contextmanager
def instrumented_driver(fa, before_step=None):
    """Record what one ``cli.train.main`` run does, without changing it:
    every host batch the loader hands out (in order; hashed into
    ``digests`` after the run, off the timed path), the host seconds of
    each loader call and of each train-step call, every train step's
    fetched metrics, the K1 launches and batches of every evaluation,
    every checkpoint save and restore. ``before_step(i)``, if given, runs
    before the i-th train-step call (from 0). Launches are counted over
    the whole run; the caller sets the counts to 0 before it."""
    from jumbo_mae_tpu_tpu_torch.cli import train as cli
    from jumbo_mae_tpu_tpu_torch.data.loader import TrainLoader
    from jumbo_mae_tpu_tpu_torch.train import engine as engine_mod
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import Checkpointer, host_state

    rec = {"images": [], "loader_wait_s": [], "dispatch_s": [], "metrics": [], "eval_k1": 0, "eval_batches": 0,
           "saves": [], "restores": [], "ckpt": None}
    saved = (TrainLoader.__next__, cli.make_train_step, engine_mod.fetch_metrics, cli.evaluate, Checkpointer.save,
             Checkpointer.restore)
    next_batch, make_step, fetch, evaluate, save, restore = saved

    def loader_next(self):
        t0 = time.perf_counter()
        batch = next_batch(self)
        rec["loader_wait_s"].append(time.perf_counter() - t0)
        rec["images"].append(batch["images"])  # a reference: the prefetch copies, nothing writes it
        return batch

    def make_train_step(**kw):
        step = make_step(**kw)

        def timed(state, batch):
            if before_step is not None:
                before_step(len(rec["dispatch_s"]))
            t0 = time.perf_counter()
            out = step(state, batch)
            rec["dispatch_s"].append(time.perf_counter() - t0)
            return out

        return timed

    def fetch_metrics(window):
        host = fetch(window)
        rec["metrics"] += [m for m in host if "learning_rate" in m]
        return host

    def counted_evaluate(eval_step, state, batches):
        k1 = fa.LAUNCHES
        n = [0]

        def counted():
            for b in batches:
                n[0] += 1
                yield b

        out = evaluate(eval_step, state, counted())
        rec["eval_k1"] += fa.LAUNCHES - k1
        rec["eval_batches"] += n[0]
        return out

    def recorded_save(self, step, state, metrics=None, extra=None):
        rec["ckpt"] = self
        rec["saves"].append({"step": step, "state": state, "extra": extra})
        return save(self, step, state, metrics=metrics, extra=extra)

    def recorded_restore(self, state, **kw):
        out = restore(self, state, **kw)
        rec["restores"].append(host_state(out[0]))  # as restored, before the steps move it
        rec["live"] = out[0]
        return out

    TrainLoader.__next__, cli.make_train_step = loader_next, make_train_step
    engine_mod.fetch_metrics, cli.evaluate = fetch_metrics, counted_evaluate
    Checkpointer.save, Checkpointer.restore = recorded_save, recorded_restore
    try:
        yield rec
    finally:
        (TrainLoader.__next__, cli.make_train_step, engine_mod.fetch_metrics, cli.evaluate, Checkpointer.save,
         Checkpointer.restore) = saved
    rec["digests"] = [_digest(images) for images in rec.pop("images")]


def run_driver(fa, argv: list[str], *, keep_state_at: int | None = None, before_step=None) -> dict:
    """One ``cli.train.main(argv)`` run with the launch counts set to 0 just
    before and read just after. ``keep_state_at``: keep a host copy of the
    state saved at that step (for the resume check); ``before_step``: as
    :func:`instrumented_driver`'s."""
    from jumbo_mae_tpu_tpu_torch.cli import train as cli
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import host_state

    with instrumented_driver(fa, before_step) as rec:
        if keep_state_at is not None:
            from jumbo_mae_tpu_tpu_torch.train.checkpoint import Checkpointer

            inner = Checkpointer.save

            def keep(self, step, state, metrics=None, extra=None):
                if step == keep_state_at:
                    rec["kept"] = host_state(state)
                return inner(self, step, state, metrics=metrics, extra=extra)

            Checkpointer.save = keep
        t0 = time.perf_counter()
        fa.LAUNCHES = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = 0
        cli.main(argv)
        rec["counts"] = {"K1": fa.LAUNCHES, "K2": fa.LAUNCHES_BWD_DQ, "K3": fa.LAUNCHES_BWD_DKV}
        rec["wall_s"] = time.perf_counter() - t0
    return rec


def _jsonl(out_dir: Path, name: str = "pretrain_vit_l16_in1k_800ep") -> list[dict]:
    return [json.loads(x) for x in (out_dir / name / f"{name}-metrics.jsonl").read_text().splitlines() if x.strip()]


def phase_driver(fa, smi: str, tmp: Path, train_step_ms: float) -> dict:
    """Phase 13: ViT-L/16 MAE pretraining from its recipe through the CLI's
    ``main`` in this process, on toy shards at 224 px written here first
    (1024 train, 256 valid images, 256 per shard): 4 worker interpreters,
    the CUDA-stream prefetch, a sanity eval, 6 steps, the final eval and
    the checkpoint."""
    import numpy as np

    from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
    from jumbo_mae_tpu_tpu_torch.data.toy import write_toy_shards
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer

    t0 = time.perf_counter()
    urls = write_toy_shards(tmp / "shards", image_size=224, n_train=1024, n_val=256, shard_size=256)
    log(f"driver: toy shards (1024 train, 256 valid, 224 px PNG) written in {time.perf_counter() - t0:.1f} s")
    sets = DRIVER_SETS + [f"data.train_shards={urls['train']}", f"data.valid_shards={urls['val']}"]
    out = tmp / "a"
    rec = run_driver(fa, ["--config", str(HERE / RECIPE), "--set", *sets, f"run.output_dir={out}"])
    steps = len(rec["metrics"])
    check(steps == DRIVER_STEPS, f"the driver ran {steps} steps, want {DRIVER_STEPS}")
    losses = [m["loss"] for m in rec["metrics"]]
    check(all(np.isfinite(losses)), f"non-finite loss through the CLI: {losses}")
    check(all(m.get("skipped", 0.0) == 0.0 for m in rec["metrics"]), "the guard skipped a step")
    log("driver: loss per step " + ", ".join(f"{x:.5f}" for x in losses))

    # launches: every train step K1 56 and K2 = K3 32 (phase 7's count);
    # every eval batch one K1 per block, no backward
    c = rec["counts"]
    check(rec["eval_batches"] == 4 and rec["eval_k1"] == 4 * 32,
          f"eval: {rec['eval_batches']} batches, {rec['eval_k1']} K1 launches (want 4 and 128)")
    train_k1 = c["K1"] - rec["eval_k1"]
    log(f"driver: launches over the run K1 {c['K1']} ({train_k1} in {steps} train steps, {rec['eval_k1']} in "
        f"{rec['eval_batches']} eval batches), K2 {c['K2']}, K3 {c['K3']}")
    check(train_k1 == 56 * steps, "K1 launches per train step through the CLI")
    check(c["K2"] == c["K3"] == 32 * steps, "K2/K3 launches per train step through the CLI")

    synthetic = next(synthetic_batches(TRAIN_BATCH, 224, seed=0))["images"]
    check(rec["digests"][0] != _digest(synthetic), "the first batch is the synthetic one, not the shards'")
    records = _jsonl(out)
    vals = [r["val/loss"] for r in records if "val/loss" in r]
    check(len(vals) == 1 and np.isfinite(vals[0]) and vals[0] > 0, f"val/loss in the metrics JSONL: {vals}")
    ck = Checkpointer(CheckpointConfig(str(out / "pretrain_vit_l16_in1k_800ep" / "ckpt")))
    check(ck.latest_step() == DRIVER_STEPS, f"ckpt/last holds {ck.committed_steps()}, want a committed step 6")

    summary = [r for r in records if "perf/images_per_sec" in r][-1]
    saver = rec["ckpt"]
    ips = summary["perf/images_per_sec"]
    step_ms = TRAIN_BATCH * 1e3 / ips
    steady_wait = rec["loader_wait_s"][2:DRIVER_STEPS]
    res = dict(
        counts=c, step_ms=step_ms, images_per_s=ips, mfu=summary["perf/mfu"], losses=losses, val_loss=vals[0],
        data_wait_s_per_step=summary["perf/data_wait_s_per_step"],
        loader_wait_s=float(np.mean(steady_wait)), save_s=saver.last_save_s, write_s=saver.last_write_s,
        save_bytes=saver.last_save_bytes, wall_s=rec["wall_s"], digests=rec["digests"][:DRIVER_STEPS],
        dispatch_s=float(np.mean(rec["dispatch_s"][2:DRIVER_STEPS])), urls=urls,
    )
    log(f"driver: {ips:.1f} images/s through cli/train.py ({step_ms:.2f} ms a step over steps 3-6 by the "
        f"CLI's StepTimer; phase 7's step on one repeated batch {train_step_ms:.2f} ms), MFU "
        f"{100 * res['mfu']:.2f}%, on {smi}")
    log(f"driver: host seconds waiting for a batch per step {res['data_wait_s_per_step']:.4f} (CLI window, steps "
        f"1-6), in the loader's __next__ {res['loader_wait_s']:.4f} (mean of its calls 3-6), in the train-step "
        f"call {res['dispatch_s']:.4f} (mean of steps 3-6), on {smi}")
    log(f"driver: checkpoint at step 6: {res['save_s']:.3f} s blocking (device to host), {res['write_s']:.3f} s "
        f"writing on the writer thread, {res['save_bytes']} bytes, on {smi}")
    log(f"driver: the whole main() call {res['wall_s']:.1f} s (state build, sanity eval, 6 steps, eval, save)")
    return res


def phase_resume(fa, smi: str, tmp: Path, straight: dict) -> dict:
    """Phase 14: 3 steps, then ``run.resume=true`` to 6, in a second output
    directory, against phase 13's 6 straight steps on its shards: the host
    batches' digests per step identical, the state restored at step 3
    equal to the state saved there bit for bit, the losses of steps 4-6
    equal (the step is deterministic on the card: the MAE gathers index a
    permutation, so their backward adds no two values into one slot; the
    relative differences are logged beside). Then whether
    ``torch.use_deterministic_algorithms`` makes a step repeat exactly."""
    import torch

    urls = straight["urls"]
    sets = DRIVER_SETS + [f"data.train_shards={urls['train']}", f"data.valid_shards={urls['val']}",
                          f"run.output_dir={tmp / 'b'}"]
    first = run_driver(fa, ["--config", str(HERE / RECIPE), "--set", *sets, "run.epochs=0.375",
                            "optim.training_steps=6"], keep_state_at=3)
    second = run_driver(fa, ["--config", str(HERE / RECIPE), "--set", *sets, "run.resume=true"])
    check(len(first["metrics"]) == 3 and len(second["metrics"]) == 3, "3 + 3 steps")
    digests = first["digests"][:3] + second["digests"][:3]
    check(digests == straight["digests"], f"per-step batch digests differ:\n{digests}\n{straight['digests']}")
    log(f"resume: the 6 batch digests equal the straight run's: {digests}")

    kept, restored = first["kept"], second["restores"][0]
    check(restored["step"] == kept["step"] == 3, "the restore is at step 3")
    check(kept["model"].keys() == restored["model"].keys(), "the restored state has other entries")
    same = all(torch.equal(restored["model"][k], v) for k, v in kept["model"].items())
    pairs = list(zip(restored["opt"]["mu"] + restored["opt"]["nu"], kept["opt"]["mu"] + kept["opt"]["nu"], strict=True))
    same &= all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    same &= all(restored["opt"][k] == kept["opt"][k] for k in ("count", "learning_rate")) and restored["seed"] == kept["seed"]
    check(same, "the state restored at step 3 differs from the state saved there")
    log("resume: the state restored at step 3 equals the saved one bit for bit (parameters, buffers, mu, nu, "
        "count, learning rate, seed)")

    a, b = straight["losses"][3:], [m["loss"] for m in second["metrics"]]
    rel = [abs(x - y) / abs(x) for x, y in zip(a, b)]
    log(f"resume: steps 4-6 loss straight {a}, resumed {b}, relative differences {rel}")
    exact = a == b
    check(exact, "the resumed losses of steps 4-6 differ from the straight run's")
    det = _determinism(second["live"])
    log(f"resume: steps 4-6 losses bit-equal: {exact}; one step repeated from the same state: "
        f"{json.dumps(det)}, on {smi}")
    return dict(rel=rel, exact=exact, **det)


def _determinism(state) -> dict:
    """Take one step twice from the same state, with the default algorithms
    and with ``torch.use_deterministic_algorithms(True, warn_only=True)``:
    are the losses and every parameter bit-equal?"""
    import torch

    from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
    from jumbo_mae_tpu_tpu_torch.train.steps import make_train_step

    step = make_train_step(guard_nonfinite=True)
    batch = next(synthetic_batches(TRAIN_BATCH, state.model.encoder_cfg.image_size, seed=5))
    params = list(state.model.parameters())
    start = ([p.detach().clone() for p in params], [m.clone() for m in state.opt_state.mu],
             [n.clone() for n in state.opt_state.nu], state.opt_state.count, state.opt_state.learning_rate, state.step)

    def once():
        with torch.no_grad():
            for p, s in zip(params, start[0]):
                p.copy_(s)
        state.opt_state.mu = [m.clone() for m in start[1]]
        state.opt_state.nu = [n.clone() for n in start[2]]
        state.opt_state.count, state.opt_state.learning_rate, state.step = start[3], start[4], start[5]
        _, m = step(state, batch)
        return m["loss"].item(), [p.detach().clone() for p in params]

    out = {}
    for name, det in (("default", False), ("deterministic", True)):
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            (l1, p1), (l2, p2) = once(), once()
        finally:
            torch.use_deterministic_algorithms(False)
        out[name] = {"loss_equal": l1 == l2, "params_equal": all(torch.equal(x, y) for x, y in zip(p1, p2))}
    return out


MAE_B16_RECIPE = "recipes/pretrain_vit_b16_in1k_1600ep.yaml"
FT_RECIPE = "recipes/finetune_vit_b16.yaml"
LINEAR_RECIPE = "recipes/linear_lars_vit_l16.yaml"
CLASSIFY_BATCH = 256
CLASSIFY_STEPS = 6
# the classify runs on the 1024 toy images: batch 256 (the finetune
# recipe's 1024 does not fit one card without grad_ckpt), 1.5 epochs = 6
# steps, warmup 0, 4 workers, wandb off
CLASSIFY_SETS = [f"run.train_batch_size={CLASSIFY_BATCH}", f"run.valid_batch_size={CLASSIFY_BATCH}",
                 "data.dataset_size=1024", "run.epochs=1.5", "optim.warmup_epochs=0", "data.workers=4",
                 "run.use_wandb=false"]


@contextlib.contextmanager
def recorded_warm_start():
    """Record what ``cli.train``'s warm start merged (the merge's name
    lists) and the classifier's head right after it, without changing
    the run."""
    from jumbo_mae_tpu_tpu_torch.cli import train as cli

    rec = {}
    real = cli._warm_start

    def warm_start(model, path):
        stats = real(model, path)
        rec["stats"] = stats
        rec["head"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters() if n.startswith("model.head.")}
        return stats

    cli._warm_start = warm_start
    try:
        yield rec
    finally:
        cli._warm_start = real


def check_merge(stats: dict, trunk: list[str], head: list[str], what: str) -> None:
    """Every trunk parameter loaded, none resized or skipped, the head new
    (fresh), the MAE save's decoder dropped (unused by the classifier)."""
    check(sorted(stats["loaded"]) == sorted(trunk), f"{what}: the merge loaded {len(stats['loaded'])} of "
          f"{len(trunk)} trunk parameters")
    check(not stats["resized"] and not stats["skipped"] and not stats["unused"], f"{what}: resized/skipped/unused "
          f"{stats['resized']} {stats['skipped']} {stats['unused']}")
    check(sorted(stats["new"]) == sorted(head), f"{what}: fresh (not in the save) {stats['new']}, want the head")
    dropped = stats["dropped"]
    check(any(n.startswith("decoder.") for n in dropped) and all(not n.startswith("encoder.") for n in dropped),
          f"{what}: the MAE save's decoder was not dropped: {dropped[:5]}")
    log(f"{what}: merge {len(stats['loaded'])} trunk parameters loaded, {len(stats['new'])} head parameters "
        f"fresh, {len(dropped)} tensors of the MAE save dropped (decoder, mask token, projections)")


def phase_mae_b16_save(fa, tmp: Path, urls: dict) -> Path:
    """Phase 15: a ViT-B/16 MAE save to warm-start from: 2 steps of
    recipes/pretrain_vit_b16_in1k_1600ep.yaml through ``cli.train.main``
    at batch 128 on phase 13's shards, 4 workers; a committed ckpt/last."""
    import numpy as np

    from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer

    sets = ["run.train_batch_size=128", "run.valid_batch_size=128", "data.dataset_size=1024", "run.epochs=0.25",
            "optim.warmup_epochs=0", "data.workers=4", "run.use_wandb=false", f"data.train_shards={urls['train']}",
            f"data.valid_shards={urls['val']}", f"run.output_dir={tmp / 'b16'}"]
    rec = run_driver(fa, ["--config", str(HERE / MAE_B16_RECIPE), "--set", *sets])
    losses = [m["loss"] for m in rec["metrics"]]
    check(len(losses) == 2 and all(np.isfinite(losses)), f"ViT-B/16 MAE: losses {losses}")
    ckdir = tmp / "b16" / "pretrain_vit_b16_in1k_1600ep" / "ckpt"
    check(Checkpointer(CheckpointConfig(str(ckdir))).latest_step() == 2, "ViT-B/16 MAE: no committed ckpt/last at 2")
    log(f"ViT-B/16 MAE save: 2 steps, losses {losses}, launches K1 {rec['counts']['K1']} K2 {rec['counts']['K2']} "
        f"K3 {rec['counts']['K3']}, ckpt/last/2 in {rec['wall_s']:.1f} s")
    return ckdir


def phase_finetune(fa, smi: str, tmp: Path, urls: dict, mae_ckpt: Path) -> dict:
    """Phase 16: finetune ViT-B/16 from recipes/finetune_vit_b16.yaml as
    written (RandAugment rand-m9-mstd0.5-inc1, Mixup 0.8 / CutMix 1.0,
    label smoothing 0.1, droppath 0.1, AdamW with layer_decay 0.75),
    warm-started from phase 15's MAE save, through ``cli.train.main``:
    batch 256 train and eval, 6 steps, warmup 0, 4 workers. Gates: the
    merge, K1 = K2 = K3 = 12 a train step and K1 = 12 an eval batch,
    finite losses, ``val/acc1``/``val/acc5`` in the JSONL, a committed
    ``best``; then ``run.eval_only=true run.resume=true
    run.eval_which=best`` reproduces that evaluation exactly."""
    import numpy as np

    from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer

    name = "finetune_vit_b16"
    sets = CLASSIFY_SETS + [f"data.train_shards={urls['train']}", f"data.valid_shards={urls['val']}",
                            f"run.output_dir={tmp / 'ft'}", f"run.pretrained_ckpt={mae_ckpt}"]
    with recorded_warm_start() as ws:
        rec = run_driver(fa, ["--config", str(HERE / FT_RECIPE), "--set", *sets])
    head = sorted(ws["head"])
    layers = 12
    trunk = [n for n in ws["stats"]["loaded"] + ws["stats"]["new"] if not n.startswith("model.head.")]
    check_merge(ws["stats"], trunk, head, "finetune")
    steps = len(rec["metrics"])
    losses = [m["loss"] for m in rec["metrics"]]
    check(steps == CLASSIFY_STEPS and all(np.isfinite(losses)), f"finetune: {steps} steps, losses {losses}")
    c = rec["counts"]
    train_k1 = c["K1"] - rec["eval_k1"]
    log(f"finetune: launches K1 {c['K1']} ({train_k1} in {steps} train steps, {rec['eval_k1']} in "
        f"{rec['eval_batches']} eval batches), K2 {c['K2']}, K3 {c['K3']}")
    check(rec["eval_batches"] > 0 and rec["eval_k1"] == layers * rec["eval_batches"], "finetune: K1 per eval batch")
    check(train_k1 == layers * steps and c["K2"] == c["K3"] == layers * steps, "finetune: K1/K2/K3 per train step")
    records = _jsonl(tmp / "ft", name)
    vals = [r for r in records if "val/acc1" in r]
    check(len(vals) == 1 and "val/acc5" in vals[0] and np.isfinite(vals[0]["val/loss"]),
          f"finetune: val/acc1 and val/acc5 in the metrics JSONL: {vals}")
    ck = Checkpointer(CheckpointConfig(str(tmp / "ft" / name / "ckpt")))
    check(ck.latest_step("best") == CLASSIFY_STEPS, f"finetune: no committed best ({ck.committed_steps('best')})")
    summary = [r for r in records if "perf/images_per_sec" in r][-1]
    ips = summary["perf/images_per_sec"]
    res = dict(counts=c, losses=losses, val=vals[0], images_per_s=ips, step_ms=CLASSIFY_BATCH * 1e3 / ips,
               mfu=summary["perf/mfu"], data_wait_s_per_step=summary["perf/data_wait_s_per_step"],
               loader_wait_s=float(np.mean(rec["loader_wait_s"][2:steps])),
               dispatch_s=float(np.mean(rec["dispatch_s"][2:steps])), wall_s=rec["wall_s"])
    log(f"finetune: losses {losses}; val {json.dumps({k: vals[0][k] for k in ('val/loss', 'val/acc1', 'val/acc5')})}")
    log(f"finetune: {ips:.1f} images/s ({res['step_ms']:.2f} ms a step over steps 3-6 by the CLI's StepTimer), "
        f"MFU {100 * res['mfu']:.2f}% (classify count), host seconds waiting for a batch per step "
        f"{res['data_wait_s_per_step']:.4f}, in the loader's __next__ {res['loader_wait_s']:.4f}, in the "
        f"train-step call {res['dispatch_s']:.4f}, on {smi}")

    # evaluate-and-exit from best: the same metrics, exactly
    ev = run_driver(fa, ["--config", str(HERE / FT_RECIPE), "--set", *sets, "run.eval_only=true", "run.resume=true",
                         "run.eval_which=best"])
    again = [r for r in _jsonl(tmp / "ft", name) if "val/acc1" in r]
    check(len(again) == 2, "eval_only logged no evaluation")
    keys = ("val/loss", "val/acc1", "val/acc5")
    same = all(again[1][k] == vals[0][k] for k in keys) and again[1]["step"] == vals[0]["step"]
    check(same and not ev["metrics"] and ev["counts"]["K2"] == 0,
          f"eval_only from best: {again[1]} against the run's {vals[0]}")
    log(f"finetune: run.eval_only from best (step {again[1]['step']}) reproduces the run's evaluation exactly; "
        f"K1 {ev['counts']['K1']} in {ev['eval_batches']} eval batches, no train step")
    return res


def phase_classify_f32_vs_cpu() -> None:
    """Phase 16b: one float32 classify step on the card against the same
    step on the CPU: ViT-B widths at 2 layers, 1000 labels, batch 2, label
    smoothing 0.1 and Mixup/CutMix pinned through ``mixup_draws=`` (CutMix
    and mixup each once), the same weights; the loss and every gradient
    within 1e-3 of scale, and the card's AdamW + layer-decay step against
    the CPU's on the card's gradients."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.models import preset
    from jumbo_mae_tpu_tpu_torch.models.classifier import ClassificationModel
    from jumbo_mae_tpu_tpu_torch.ops.mixup import sample_draws
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig, make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = preset("vit_b16", posemb="sincos2d", layers=2, dtype="float32", attn_impl="flash")
    opt = OptimConfig(learning_rate=3e-3, lr_scaling="none", layer_decay=0.75, warmup_steps=0, training_steps=10)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 1000, 2))
    # one model a device, put back to its initial weights before each use
    models = {device: ClassificationModel(cfg, 0.8, 1.0, 0.1, device=device, seed=0).train()
              for device in ("cuda", "cpu")}
    initial = {device: {n: t.clone() for n, t in m.state_dict().items()} for device, m in models.items()}

    def fresh(device: str):
        model = models[device]
        model.load_state_dict(initial[device])
        model.zero_grad(set_to_none=True)
        return model

    for take_mixup in (True, False):
        while True:  # draws whose coin picks mixup, then CutMix
            draws = sample_draws(rng, 2, 0.8, 1.0)
            if (draws["coin"] > 0.5) == take_mixup:
                break
        res = {}
        for device in ("cuda", "cpu"):
            model = fresh(device)
            out = model(images.to(device), labels.to(device), mixup_draws=draws)
            out["loss"].mean().backward()
            grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
            tx = make_optimizer(opt, 2, num_layers=cfg.layers)
            state = tx.init(model)
            before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            tx.update(state, list(model.parameters()), [p.grad for p in model.parameters()])
            step = {n: p.detach().cpu() - before[n] for n, p in model.named_parameters()}
            res[device] = (out["loss"].detach().cpu(), grads, step, before)
        (lg, gg, sg, _), (lc, gc, _, bc) = res["cuda"], res["cpu"]
        check(bool(torch.allclose(lg, lc, rtol=1e-3, atol=0)), f"f32 classify loss cuda {lg} vs cpu {lc}")
        gmax = max(g.abs().max().item() for g in gc.values())
        worst = 0.0
        for n in gc:
            scale = gc[n].abs().max().item()
            err = (gg[n] - gc[n]).abs().max().item()
            if scale > 1e-3 * gmax:  # the floor holds the tensors whose true gradient is zero
                worst = max(worst, err / scale)
            check(err <= 1e-3 * scale + 1e-6 * gmax, f"classify gradient {n}: max diff {err:.3e} vs scale {scale:.3e}")
        # the card's step against the CPU optimizer on the card's gradients
        replay = fresh("cpu")
        tx = make_optimizer(opt, 2, num_layers=cfg.layers)
        state = tx.init(replay)
        tx.update(state, list(replay.parameters()), [gg[n] for n, _ in replay.named_parameters()])
        worst_step = 0.0
        for n, p in replay.named_parameters():
            want = p.detach() - bc[n]
            scale = want.abs().max().item()
            mag = p.detach().abs() + want.abs()
            ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
            diff = (sg[n] - want).abs()
            worst_step = max(worst_step, (diff - ulp).max().item() / max(scale, 1e-30))
            check(bool((diff <= 1e-3 * scale + ulp).all()), f"classify step {n}: the card's AdamW + layer decay "
                  f"differs from the CPU's on the same gradients by {diff.max().item():.3e} (scale {scale:.3e})")
        log(f"f32 classify step cuda vs CPU ({'mixup' if take_mixup else 'CutMix'} pinned): loss {lg.mean():.7f} vs "
            f"{lc.mean():.7f}; every gradient within 1e-3 of its scale, with a floor of 1e-6 of the largest (worst "
            f"{worst:.2e} among tensors above 1e-3 of the largest); the card's AdamW + "
            f"layer-decay step equals the CPU's on its gradients (worst {worst_step:.2e} of the step's scale)")


def phase_linear(fa, smi: str, tmp: Path, urls: dict, mae_l16_ckpt: Path) -> dict:
    """Phase 17: linear probe ViT-L/16 from recipes/linear_lars_vit_l16.yaml
    (LARS, the BatchNorm head, the trunk frozen) warm-started from phase
    13's ViT-L/16 MAE save, through ``cli.train.main`` at batch 256 for 6
    steps. Gates: the merge; K1 = 24 and K2 = K3 = 0 a step; every trunk
    parameter bit-unchanged (the save after 6 steps against the MAE
    save's encoder); the head and the BatchNorm statistics moved; finite
    losses; ``val/acc1`` in the JSONL."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.train.checkpoint import read_state

    name = "linear_lars_vit_l16"
    sets = CLASSIFY_SETS + [f"data.train_shards={urls['train']}", f"data.valid_shards={urls['val']}",
                            f"run.output_dir={tmp / 'lin'}", f"run.pretrained_ckpt={mae_l16_ckpt}"]
    with recorded_warm_start() as ws:
        rec = run_driver(fa, ["--config", str(HERE / LINEAR_RECIPE), "--set", *sets])
    trunk = [n for n in ws["stats"]["loaded"] + ws["stats"]["new"] if not n.startswith("model.head.")]
    check_merge(ws["stats"], trunk, sorted(ws["head"]), "linear probe")
    steps = len(rec["metrics"])
    losses = [m["loss"] for m in rec["metrics"]]
    check(steps == CLASSIFY_STEPS and all(np.isfinite(losses)), f"linear probe: {steps} steps, losses {losses}")
    c = rec["counts"]
    train_k1 = c["K1"] - rec["eval_k1"]
    log(f"linear probe: launches K1 {c['K1']} ({train_k1} in {steps} train steps, {rec['eval_k1']} in "
        f"{rec['eval_batches']} eval batches), K2 {c['K2']}, K3 {c['K3']}")
    check(train_k1 == 24 * steps and c["K2"] == c["K3"] == 0, "linear probe: K1 = 24 and K2 = K3 = 0 a step")
    check(rec["eval_k1"] == 24 * rec["eval_batches"], "linear probe: K1 per eval batch")
    after = read_state(tmp / "lin" / name / "ckpt")["model"]
    mae = read_state(mae_l16_ckpt)["model"]
    same = [torch.equal(after[n], mae["encoder." + n[len("model."):]]) for n in trunk]
    check(all(same), f"linear probe: {same.count(False)} trunk parameters moved under LARS")
    moved = {n: not torch.equal(after[n], ws["head"][n]) for n in ws["head"]}
    check(all(moved.values()), f"linear probe: head parameters unchanged: {moved}")
    rm, rv = after["model.head.bn.running_mean"], after["model.head.bn.running_var"]
    check(bool(rm.abs().max() > 0) and not torch.equal(rv, torch.ones_like(rv)), "linear probe: BatchNorm stats unchanged")
    vals = [r for r in _jsonl(tmp / "lin", name) if "val/acc1" in r]
    check(len(vals) == 1 and np.isfinite(vals[0]["val/loss"]), f"linear probe: val/acc1 in the metrics JSONL: {vals}")
    records = [r for r in _jsonl(tmp / "lin", name) if "perf/images_per_sec" in r]
    ips = records[-1]["perf/images_per_sec"]
    res = dict(counts=c, losses=losses, val=vals[0], images_per_s=ips, step_ms=CLASSIFY_BATCH * 1e3 / ips,
               mfu=records[-1]["perf/mfu"], dispatch_s=float(np.mean(rec["dispatch_s"][2:steps])), wall_s=rec["wall_s"])
    log(f"linear probe: {len(trunk)} trunk parameters bit-unchanged after {steps} LARS steps; head and BatchNorm "
        f"statistics moved; losses {losses}; val/acc1 {vals[0]['val/acc1']}; {ips:.1f} images/s "
        f"({res['step_ms']:.2f} ms a step), MFU {100 * res['mfu']:.2f}% (classify count: 3x forward, though the "
        f"trunk runs no backward), train-step call {res['dispatch_s']:.4f} s, on {smi}")
    return res


TOY_PT_STEPS, TOY_PR_STEPS = 600, 400


def _toy_overrides(tmp: Path, shards: dict, extra: list[str]) -> list[str]:
    """tests/test_learning_e2e.py's ``_overrides``, without
    ``data.valid_cache`` (ROADMAP A3)."""
    return [f"data.train_shards={shards['train']}", f"data.valid_shards={shards['val']}", "data.image_size=32",
            "data.crop_mode=none", "data.hflip=0.0", "data.workers=0", "run.synthetic_data=false",
            "run.use_wandb=false", "run.sanity_eval=false", "model.preset=vit_t16"] + extra


def toy_probe_proof(tmp: Path, device: str = "cuda", *, pt_steps: int = TOY_PT_STEPS,
                    pr_steps: int = TOY_PR_STEPS, seed: int = 0, runs=("pretrained", "random")) -> dict:
    """ROADMAP A4's gate, tests/test_learning_e2e.py's pretrain-then-probe
    proof through ``cli.train.main``: for ``"pretrained"`` in ``runs``, toy
    MAE pretraining (``pt_steps``), then the GAP linear probe (SGD,
    ``pr_steps``) from that save; for ``"random"``, the same probe from a
    random init. Every run is seeded with ``seed`` (0, the test's, by
    default). Returns the probes' final ``val/acc1`` and the seconds."""
    from jumbo_mae_tpu_tpu_torch.cli import train as cli
    from jumbo_mae_tpu_tpu_torch.data.toy import toy_pretrain_hparams, write_toy_shards

    recipe = str(HERE / "recipes" / "smoke_cpu.yaml")
    shards = write_toy_shards(tmp / "toyshards", n_train=2048, n_val=512)
    dev = ["--device", device]

    def probe(name: str, pretrained: str | None) -> float:
        extra = [f"run.output_dir={tmp}/{name}", f"run.name={name}", "run.mode=linear", f"run.seed={seed}",
                 f"run.init_seed={seed}", f"run.training_steps={pr_steps}", "run.train_batch_size=64",
                 "run.valid_batch_size=64", f"run.eval_interval={pr_steps}", "run.log_interval=800",
                 "model.overrides={image_size: 32, patch_size: 4, layers: 4, posemb: sincos2d, dtype: float32, "
                 "labels: 10, pooling: gap}", "model.criterion=ce", "optim.name=sgd", "optim.learning_rate=0.3",
                 "optim.lr_scaling=none", "optim.momentum=0.9", "optim.warmup_steps=0",
                 f"optim.training_steps={pr_steps}"]
        if pretrained:
            extra.append(f"run.pretrained_ckpt={pretrained}")
        cli.main(["--config", recipe, *dev, "--set", *_toy_overrides(tmp, shards, extra)])
        return [r for r in _jsonl(tmp / name, name) if "val/acc1" in r][-1]["val/acc1"]

    res = {}
    if "pretrained" in runs:
        t0 = time.perf_counter()
        cli.main(["--config", recipe, *dev, "--set", *_toy_overrides(tmp, shards, [
            f"run.output_dir={tmp}/pt", "run.name=toy_pretrain"] + toy_pretrain_hparams(pt_steps, seed=seed))])
        t1 = time.perf_counter()
        res["acc_pt"] = probe("probe_pt", f"{tmp}/pt/toy_pretrain/ckpt")
        res.update(pt_val_loss=[r for r in _jsonl(tmp / "pt", "toy_pretrain") if "val/loss" in r][-1]["val/loss"],
                   pretrain_s=t1 - t0, probe_pt_s=time.perf_counter() - t1)
    if "random" in runs:
        t0 = time.perf_counter()
        res["acc_rand"] = probe("probe_rand", None)
        res["probe_rand_s"] = time.perf_counter() - t0
    return res


def phase_toy_proof(smi: str, tmp: Path) -> dict:
    """Phase 18: the toy pretrain-then-probe proof on the card, with the
    JAX test's gates: the pretrained probe beats the random one by more
    than 0.1, and by more than 1.5x, and reads above 0.25.

    It runs in two child processes at once, one pretraining and probing
    from the save, one probing from a random init, each with PyTorch's
    defaults as a user's ``cli.train`` would have them. The float32
    phases before it turn cuDNN's TF32 off in this process (the toy
    model's patch convolution is its one cuDNN call), and run here the
    proof did not repeat from run to run; in a fresh process it repeats
    bit for bit."""
    code = ("import json, sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "tmp = Path(sys.argv[2]); res = chip_smoke.toy_probe_proof(tmp, runs=(sys.argv[3],)); "
            "(tmp / 'result.json').write_text(json.dumps(res))")
    dirs = {which: tmp / which for which in ("pretrained", "random")}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(HERE), str(d), which]) for which, d in dirs.items()]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(codes == [0, 0], f"toy proof: the child processes exited with {codes}")
    res = {}
    for d in dirs.values():
        res.update(json.loads((d / "result.json").read_text()))
    a, r = res["acc_pt"], res["acc_rand"]
    log(f"toy proof: probe val/acc1 pretrained {a:.4f}, random init {r:.4f} (pretrain val/loss "
        f"{res['pt_val_loss']:.5f}; pretrain {res['pretrain_s']:.1f} s, then its probe {res['probe_pt_s']:.1f} s; "
        f"the random-init probe beside them {res['probe_rand_s']:.1f} s), on {smi}")
    check(a > r + 0.1, f"toy proof: pretrained probe {a} not above random {r} + 0.1")
    check(a > 1.5 * r, f"toy proof: pretrained probe {a} not above 1.5 x random {r}")
    check(a > 0.25, f"toy proof: pretrained probe {a} not above 0.25")
    return res


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

    build_kernels(_build)

    errs = phase_kernels(fa)
    bwd_errs = phase_bwd_kernels(fa)
    k1_timings = phase_timings(fa)
    bwd_timings = phase_bwd_timings(fa, k1_timings)
    from jumbo_mae_tpu_tpu_torch.models import preset

    # recipes/finetune_vit_b16.yaml's model; the CLI builds the same one
    vit_b16 = preset("vit_b16", posemb="sincos2d")
    cli_args = ("--preset", "vit_b16", "--set", "posemb=sincos2d")
    serve_launches, dispatches = phase_slice(fa, smi, vit_b16, "cuda", cli_args)
    log(f"serving path: {serve_launches} K1 launches over {dispatches} dispatches")
    train = phase_train(fa, smi)
    phase_train_f32_vs_cpu()
    phase_auto_head_dims(fa)
    k4_errs = phase_k4(fa)
    k4_timing = phase_k4_timing(fa)
    phase_ring_op(fa)
    seq_train = phase_seq_train(fa, smi)
    log(f"sequence-parallel step {seq_train['step_ms']:.2f} ms against {train['step_ms']:.2f} ms without the "
        f"ring (phase 7), on {smi}")
    phase_ring_f32_vs_plain()
    backends = phase_backends()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_driver_"))
    try:
        driver = phase_driver(fa, smi, tmp, train["step_ms"])
        resume = phase_resume(fa, smi, tmp, driver)
        t0 = time.perf_counter()
        mae_b16 = phase_mae_b16_save(fa, tmp, driver["urls"])
        t1 = time.perf_counter()
        finetune = phase_finetune(fa, smi, tmp, driver["urls"], mae_b16)
        t2 = time.perf_counter()
        phase_classify_f32_vs_cpu()
        t3 = time.perf_counter()
        # phase 13's ViT-L/16 save, read before its directory goes
        linear = phase_linear(fa, smi, tmp, driver["urls"], tmp / "a" / "pretrain_vit_l16_in1k_800ep" / "ckpt")
        t4 = time.perf_counter()
        log(f"seconds: phase 15 {t1 - t0:.1f}, phase 16 {t2 - t1:.1f}, its f32 step {t3 - t2:.1f}, phase 17 "
            f"{t4 - t3:.1f}; phases 1-14 took {t0 - t_start:.1f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    keys = ("step_ms", "images_per_s", "mfu", "data_wait_s_per_step", "loader_wait_s", "dispatch_s", "save_s", "write_s",
            "save_bytes")
    summary = {"backends": backends, **{k: driver[k] for k in keys}, "phase7_step_ms": train["step_ms"],
               "resume": resume}
    log(f"cli/train.py: {json.dumps(summary)} on {smi}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_toy_"))
    t0 = time.perf_counter()
    try:
        toy = phase_toy_proof(smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"seconds: phase 18 {time.perf_counter() - t0:.1f}")
    classify = {"finetune": {k: v for k, v in finetune.items() if k != "counts"},
                "linear": {k: v for k, v in linear.items() if k != "counts"}, "toy_proof": toy}
    log(f"classify paths: {json.dumps(classify)} on {smi}")

    # every number of the line comes from the training slice (the main
    # path): launches from its run, errors and times at its decoder shape.
    # ms, plain_ms and library_ms are device ms per call from CUDA-graph
    # replay for every kernel; eager_ms is the kernel's time over eager
    # back-to-back launches, which the wrapper's host time bounds where it
    # exceeds the kernel's (the method of the lines before graph replay)
    kernels = []
    ft_err = {"K1": errs[("bfloat16", FT_SHAPE, FT_SHAPE[1])],
              "K2": bwd_errs[("bfloat16", FT_SHAPE, FT_SHAPE[1], "dq")],
              "K3": max(bwd_errs[("bfloat16", FT_SHAPE, FT_SHAPE[1], g)] for g in ("dk", "dv"))}
    for key, name, src, line, err in (
        ("K1", "flash_attention_fwd", "flash_fwd.cu", 84, errs[("bfloat16", DEC_SHAPE, DEC_SHAPE[1])]),
        ("K2", "flash_attention_bwd_dq", "flash_bwd.cu", 120, bwd_errs[("bfloat16", DEC_SHAPE, DEC_SHAPE[1], "dq")]),
        ("K3", "flash_attention_bwd_dkv", "flash_bwd.cu", 154,
         max(bwd_errs[("bfloat16", DEC_SHAPE, DEC_SHAPE[1], g)] for g in ("dk", "dv"))),
    ):
        t = k1_timings[DEC_SHAPE] if key == "K1" else bwd_timings[(key, DEC_SHAPE)]
        ft = k1_timings[FT_SHAPE] if key == "K1" else bwd_timings[(key, FT_SHAPE)]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"jumbo_mae_tpu_tpu_torch/csrc/{src}",
            "replaces": f"jumbo_mae_tpu_tpu/ops/pallas/attention.py:{line}",
            "launches": train["counts"][key],
            "cli_launches": driver["counts"][key],
            "finetune_launches": finetune["counts"][key],
            "linear_launches": linear["counts"][key],
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "eager_ms": t["eager_ms"],
            "finetune_max_abs_err": ft_err[key],
            **{f"finetune_{k}": ft[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        })
    # FlashAttention, the counterpart of pallas_flash_attention (the plain
    # custom_vjp over K1-K3): forward + backward through autograd at the
    # decoder shape against SDPA's forward + backward; launches are its
    # backward passes on the training slice (each one K2 and one K3; its
    # forwards are K1's launches), the error the worst of K2/K3's there
    kernels.append({
        "name": "FlashAttention (flash_attention forward + backward)",
        "route": "cuda",
        "source": "jumbo_mae_tpu_tpu_torch/csrc/flash_fwd.cu + jumbo_mae_tpu_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "jumbo_mae_tpu_tpu/ops/pallas/attention.py:355",
        "launches": train["counts"]["K2"],
        "finetune_launches": finetune["counts"]["K2"],
        "linear_launches": linear["counts"]["K2"],
        "max_abs_err": max(bwd_errs[("bfloat16", DEC_SHAPE, DEC_SHAPE[1], g)] for g in ("dq", "dk", "dv")),
        **bwd_timings[("FlashAttention", DEC_SHAPE)],
        **{f"finetune_{k}": v for k, v in bwd_timings[("FlashAttention", FT_SHAPE)].items() if k != "eager_ms"},
    })
    # K4: launches from the sequence-parallel slice (its main path), the
    # error and times at its hop shape
    kernels.append({
        "name": "flash_attention_with_lse",
        "route": "cuda",
        "source": "jumbo_mae_tpu_tpu_torch/csrc/flash_fwd.cu + jumbo_mae_tpu_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "jumbo_mae_tpu_tpu/ops/pallas/attention.py:397",
        "launches": seq_train["counts"]["K4"],
        "max_abs_err": k4_errs[("bfloat16", HOP_SHAPE)],
        **k4_timing,
    })
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
