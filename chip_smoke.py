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
   512x13x16x64; head_dims 32, 80, 128 at short and ragged lengths;
   head_dim 80's edges, ``H80_EDGES``) and Sq != Sk both ways, packed and
   not; two bf16 runs bit-identical; plus strided q/k/v views of a fused
   projection (head_dims 64 and 80) and NaN past the sequence unread;
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
6. the serving slice — the ViT-B/16 classifier of
   recipes/finetune_vit_b16.yaml (12 layers, dim 768, 3 CLS tokens,
   sincos2d, 1000 labels, bf16 compute, random weights from the recipe's
   ``run.init_seed``) served through ``InferenceEngine`` built from the
   recipe (logits, features cls and gap; requests of 1, 5, 64 and 70
   images) and through ``cli.predict --config``:
   shapes, finite values, kernel launches = 12 x (dispatches + captures:
   each graph's eager first run launches too), padding
   inertness, the float32 engine on the card against the float32 engine
   on the CPU, images/s;
7. the training slice — one MAE pretraining step of ViT-L/16 as
   recipes/pretrain_vit_l16_in1k_800ep.yaml builds it (24 layers, dim
   1024, mask 0.75, sincos2d, grad_ckpt; decoder 8 x 512 x 16 heads;
   norm_pix_loss; bf16 compute; AdamW with bf16 mu; random weights from a
   seed) at batch 128 through ``create_state`` + ``make_train_step`` on
   ``synthetic_batches``: 3 warm-up and 10 timed steps on one repeated
   batch; the kernels' launch counts, no call of the plain D pass, a
   finite loss that falls, step ms, images/s, MFU and peak memory; the
   same 13 steps with ``diag=True`` from a state of the same seeds (every
   step a diag step): losses and parameters bit-equal, the same launches,
   step ms beside; one more diag step's (29, 3) group statistics against
   a float64 recomputation from the same tensors (norms at 1e-5, the
   update ratio at 1e-4), and the device ms of the parameter copy and of
   ``group_stats``; then
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
   (1024 train, 256 valid, 256 a shard) that a child process started at
   the top of the run writes beside phases 2-12: launch counts
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
   settings (two child processes, run beside phases 26-28): the
   pretrained probe above the random one by 0.1 and by 1.5x, and above
   0.25.
19. serving the saves (run after phase 17, while the saves of phases 13,
   16 and 17 exist) through ``cli.predict.main`` in this process, on 70
   PNG files written from phase 13's validation shard and decoded by the
   port (K1 counted per forward: a replay, or a capture's eager first
   run): ViT-B/16 logits from phase 16's ``best`` (K1 = 12 a forward,
   one JSON line an image, within bf16 relative error 1e-2 of the
   classifier ``Checkpointer.restore_eval`` restores, top-1 identical);
   its features and int8 (the package's parity gates, feature cosine >=
   0.999 and top-1 agreement >= 0.98; compression and int8 bytes);
   ViT-L/16 linear-probe logits from phase 17's save (K1 = 24 a forward,
   the BatchNorm statistics bit-equal to the save's); the ViT-L/16
   reconstruction from phase 13's save (K1 = 32 a forward, 147 of 196
   patches masked), then twice with the encoder cache (the second call
   all hits, 8 K1 a decode dispatch; both bit-equal to the fused path);
   ``--serve`` within bf16 tolerance of the direct path; the float32
   engine on the card against the CPU's. Restore seconds and bytes,
   ms a dispatch and images/s at buckets 1, 8, 64 in bf16 and int8, the
   reconstruction cold and warm, and the warmup's seconds.
20. the replicated serving tier (after phase 19, on its 70 PNGs and
   phase 16's ``best``): every engine dispatch on the card replays a CUDA
   graph captured per (task, bucket); ViT-B/16 logits at buckets 1, 8
   and 64 from graphs beside the same model's eager forward with the
   same upload and fetch (top-1 identical, bf16 relative error <= 1e-2,
   bit-equality reported), K1 = 12 a replay and 12 K1 kernels in a
   ``torch.profiler`` trace of one bucket-64 replay; ``compile_counts``
   flat over 50 requests after ``warmup`` and across ``swap_weights`` +
   ``restore_snapshot`` (the rollback bit-equal); capture and first-run
   seconds and pool bytes per bucket; the packed mix 224:0.5, 160:0.3,
   96:0.2 (``packed_parity`` cosine >= 0.999, top-1 1.0, in bf16 and
   float32; the token pad; ms a packed dispatch against one dispatch per
   resolution); ``cli.predict --serve --replicas 2``, then ``--pack``
   with ``--swap-watch``: a push promoted, a corrupt copy rolled back at
   parity, every request served.
21. warm restarts (after phase 20, on phase 16's ``best`` and phase 13's
   MAE save): the restart probe ``python -m
   jumbo_mae_tpu_tpu_torch.infer.warmcache`` in a process of its own, cold
   against an empty directory, then warm against the same, for ViT-B/16
   features and logits in bf16 and in int8 and for the ViT-L/16
   reconstruction, and for ViT-B/16 a third run after one entry is
   corrupted: each build split into its parts (construction, the save's
   restore, the graft, the copy to the card, quantization, the entry's
   load and write; first runs and captures), ``warm_hits``, misses and
   captures; the warm outputs bit-equal to the cold, the corrupted entry
   quarantined and counted as a miss with outputs still bit-equal, K1 =
   12 (32 at ViT-L/16) x (dispatches + captures); the two bf16 runs go
   beside the three int8 runs.
22. batch jobs: one image's features at every bucket 1-64 (bit-equal or
   not), then ``python -m jumbo_mae_tpu_tpu_torch.cli.batch`` over phase
   13's first 2 train shards (512 images) with ViT-B/16 features from
   phase 16's ``best``, 2 replicas, buckets up to 64, each run a process
   of its own: straight with 2 job workers (images/s, the scheduler's
   occupancy, K1 = 12 x (dispatches + captures)), SIGKILLed once a part
   is durable and run again (1 worker), and with worker w0 of 2 killed by
   the ``batch.worker`` fault site (a lease steal); their manifests byte-identical to the straight
   run's if every bucket agreed, else every record within relative error
   1e-2 and cosine 0.999 of it, and byte-identical on a one-bucket ladder
   (straight and SIGKILLed); ``python -m
   jumbo_mae_tpu_tpu_torch.tools.batch_doctor`` exits 0 after each run.
   The straight run goes beside the SIGKILLed ones.
23. billing, the autoscaler and the publisher (after phase 22, on phase
   16's ``best``, phase 19's 70 PNGs and phase 13's shards): (a)
   ``cli.predict --serve --replicas 1 --tenants web=interactive,
   scrape=batch:budget=...:window=2 --autoscale 1:2 --access-log`` in a
   process of its own, a burst of 420 requests then 210 at 40 ms:
   one scale-up to 2 and one drain back to 1 journaled, no request failed
   or shed, the meter's conservation law to 1e-9, each tenant's FLOPs the
   analytic count of its rows (bucket / batch of the ViT-B/16 logits
   forward), the scrape tenant's budget gauge at 0, K1 = 12 x (dispatches
   + captures) over both replicas; the roofline capacity a replica on the
   H100 beside the measured rate; (b) 4 steps of
   ``recipes/finetune_vit_b16.yaml`` at batch 256 through
   ``cli.train.main`` with ``run.publish_dir`` and a checkpoint every 2
   steps (K1 = K2 = K3 = 12 a step): an int8 full artifact, then a delta
   (learning rate 2e-6, a schedule's tail, and layer decay 0.05, so the
   low blocks' kernels ride the base and the features stay within the
   swap's parity gate), both
   verified, the delta's fingerprint that of a full export of the same
   tree, a third export corrupted by the ``publish.export`` fault site;
   pushed into ``cli.predict --serve --replicas 2 --swap-watch``, the two
   good ones promoted and the corrupt one quarantined before restore,
   ``publish_doctor`` exiting 0; (c) ``cli.batch`` over phase 13's first
   2 shards (512 images, one replica) with a budgeted tenant: ``tenant_usage`` in the summary, each row
   billed its analytic share, ``cost_doctor`` reconciling the rows with
   the ledger; (d) ``predict_train_step`` of the ViT-L/16 MAE step at
   batch 128 on the H100 row beside phase 7's measured step.
24. serving telemetry and health (after phase 23, on phase 16's ``best``
   and phase 19's 70 PNGs): ms a dispatch by graph replay at buckets 1
   and 64 with the metrics registry on and with ``NULL_REGISTRY`` in
   turns, and the host µs of one dispatch's engine hooks; then, in a
   process of its own, ``cli.predict --serve --replicas 2 --warmup
   --metrics-port 0 --slo ... --access-log --swap-watch --burst 64
   --metrics-hold-s`` over 980 requests (64 in a burst, then 30 ms apart) under the fault plan
   ``serve.replica`` (r1's first flush), ``serve.preempt`` (r0, later)
   and ``ckpt.load:corrupt`` (the push named ``corrupt``), scraped over
   loopback while it serves: ``/healthz`` 200 and ready once the pool is
   up; one crash and one restart of r1 and one preemption of r0, every
   request served; a good push promoted, the corrupt push rolled back at
   parity (``serve_swap_rollbacks_total`` 1), and, with a ballast tensor
   held by this process until the card's free memory is short of the
   push, the next push rejected at stage ``headroom`` naming the card,
   nothing flipped, the pool serving on; ``serve_replica_up`` 1 for both,
   ``infer_requests_total`` = requests + requeues,
   ``mem_device_bytes{device="cuda:0"}`` in (0, the card's memory],
   ``mem_hbm_predict_vs_measured`` finite for every captured key with a
   predicted peak, the capture sentinel at 0 violations, K1 = 12 x
   (dispatches + captures) over every engine the pool built, and each
   engine's logits of the 70 files bit-equal to phase 19's; the wall ms
   of a scrape and of ``/healthz``.
25. ViT-H/14 MAE pretraining from recipes/pretrain_vit_h14_in1k_fsdp.yaml
   (after phase 24, on phase 13's shards; alone: scripts/torch_h14.py):
   K1-K3 at the slice's encoder (256, 67, 16, 80: all three on wgmma
   with 64 + 16-column panels) and decoder (256, 259, 16, 32) shapes
   against their plain versions at the gates of phases 3-4 and timed as
   phase 5 times them; ``blockwise_attention`` against the full scores at
   (2, 4099, 16, 64), with and without a bias, its peak memory below
   theirs; two native-reader streams of the same shards alike; the
   recipe through ``cli.train`` ``main`` with ``mesh.data=1``, batch
   256, ``data.use_native`` and ``data.valid_cache``: 3 steps (K1 72, K2 = K3 40 a step, finite
   losses, one analytic ``compiled_program`` row with the card's peak,
   HFU ≥ MFU), one eval (K1 40, the cache written), a save; a second
   eval of the saved state through the CLI's eval step and valid iterator
   that opens no shard and gives the same loss bit for bit; on that state
   the step at batch 256 under ``remat_policy`` "dots" and "none"
   (launches per step: K1 72, K2 = K3 40; step ms, peak memory; the
   step's cost row and HFU/MFU printed) and at batch 8 without gradient
   checkpointing (K1 40), and the loss and gradients of the three alike
   bit for bit; and the reconstruction figure drawn from the save by
   ``tools/reconstruct.py`` (8 rows, 1806 x 902 px, the original panels
   bit-equal to the validation images, K1 = 40 x forwards).
26. the training run's safety layers (after phase 25, on phase 13's
   shards): phase 13's recipe through ``cli.train.main`` with
   ``run.faults=train.loss:nan@n=2..3;host.leak:corrupt(16)``, a log window
   a step, a save every 2 steps and ``run.sentinel_patience=2``: the guard
   skips steps 3 and 4, the divergence sentinel rolls the run back at step
   4 to the step-2 save (parameters, optimizer state, step, seed, data
   cursor) and steps 3-6 run again; the journal's sentinel, rollback, step
   and shutdown rows in order; steps 1-2 and the rerun's 3-6 equal to
   phase 13's losses within one bf16 ulp (the largest difference printed);
   K1 56 and K2 = K3 32 per dispatch (8 dispatches: a skipped step runs its
   backward) and 32 K1 per eval batch; a ``mem_sample`` a window with the
   card's bytes; the leak sentinel naming ``fault_ballast`` and
   ``tools/mem_doctor.py`` naming it from the journal; 0 unexpected
   retraces. What watches the run is on too: exactly three flight
   records (the first bad window, one dump for steps 3-4; the leak; the
   rollback), each holding the window it was dumped in; a goodput report
   at the saves of steps 2, 4 and 6 and at shutdown (``completed``: steps
   5, recompute steps 2, conservation error 0), ``tools/goodput_doctor.py``
   exiting 0; ``run.telemetry`` on a free port scraped by a thread while
   the run is live (the ``train_*``, ``goodput_*``, ``span_seconds``,
   ``run_generation`` and ``model_grad_norm{group="blocks.0"}``
   families; ``/healthz`` 200, degraded once the leak sentinel fires);
   the watch hooks' host µs a dispatch. With ``run.diag_every=1``: the
   ``nonfinite_step`` record names ``patch_embed``, every step row
   carries the 29 groups, one analytic ``compiled_program`` row with the
   card's peak, HFU ≥ MFU in every window, and
   ``tools/run_doctor.py`` (naming the group) and ``tools/perf_doctor.py``
   exit 0 on the journal.
27. traces (after phase 26's saves are deleted, in this process): phase
   13's recipe, 3 steps, a log window a step, the final eval and its save,
   with ``run.chrome_trace`` and ``run.profile_dir``: one ``data_wait``
   and one ``train_step`` span a dispatch in the chrome trace, and K1, K2
   and K3 named in the ``torch.profiler`` trace as many times as their
   launch counters counted (the trace's bytes and export seconds).
28. the hang, beside phases 26 and 27 in a child process of ``python -m
   jumbo_mae_tpu_tpu_torch.cli.train``: phase 13's recipe and shards, 4
   steps, ``run.hangwatch_deadline_s=10`` and
   ``run.faults=fleet.wedge:delay(600)@key~3,n<1``: exit code 44 within
   the deadline, the poll and 5 s of the last step beat, ``hang_detected``
   journaled with ``stalled_s`` >= 10, a final goodput report with
   ``reason: "hang"`` and ``hang_latency`` >= 10, a ``hang_detected``
   flight record and ``[train] HANG`` on its stdout.
29. a save's host copy and ``--distributed`` (on phase 13's shards; (a)
   beside phases 15-17, (b) and (c) beside phases 21-22, where no gate
   rides on timing or on the card's free memory; alone, one leg after
   the other: scripts/torch_distributed.py), each leg in fresh child
   processes of
   ``cli.train.main`` with the launch counts set to 0 before and read
   after: (a) phase 13's recipe, 6 steps, a log window a step, a save
   every 2 steps, memwatch at its defaults and no fault plan: no
   ``mem_leak_suspect``, the host copy named ``ckpt_host_copy`` in every
   memory sample, the resident set after each save printed; (b) two ranks
   of ``--distributed --coordinator 127.0.0.1:PORT`` sharing the card
   over gloo (the backend rule's choice, printed), ``mesh.data=2`` (64
   rows each), 4 steps, saves at 2 and 4 and the final eval: K1 56 and
   K2 = K3 32 a step in each rank and K1 32 an eval batch, finite losses
   equal on both, the final parameters' digests equal, rank 0's saves
   committed with both cursors (``per_process``), ``shard_cursor`` rows
   at ``world: 2`` in ``journal/`` and ``journal-host1/``, one
   ``val/loss`` although rank 1's stripe of the one valid shard is empty,
   and the gradient all-reduce's share of a step (two ranks on one card:
   not a scaling figure); (c) one process ``run.eval_only`` on (b)'s
   step-4 save within 1e-3 relative of (b)'s final eval.

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
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent

VIT_B_SHAPE = (64, 199, 12, 64)  # ViT-B/16 at 224 px, batch 64
# the finetune slice: ViT-B/16 at 224 px (196 patches + 3 CLS) at its batch 256
FT_SHAPE = (256, 199, 12, 64)
# the training slice: MAE encoder (49 visible + 3 CLS) and decoder (196 + 3)
# of the ViT-L/16 recipe at batch 128
ENC_SHAPE = (128, 52, 16, 64)
DEC_SHAPE = (128, 199, 16, 32)
# the serving slice's reconstruction of ViT-L/16 at bucket 64: its encoder
# and decoder, without lse
RECON_ENC_SHAPE = (64, 52, 16, 64)
RECON_DEC_SHAPE = (64, 199, 16, 32)
# the tile and panel edges of the head_dim-80 kernels (K1, K2, K3; a
# 64-column and a 16-column swizzled panel): S = 1, 9, 17, 33 at H = 16 on
# the edges of the heads-per-tile rule (16, 4, 2, 1 heads), 64/65, the
# ViT-H/14 encoder's 67 (a 64-row tile and a ragged one of 3 rows),
# 128/129; H = 12 and 6 at a packed length (the last packed tile part
# empty)
H80_EDGES = [
    (8, 1, 16, 80),
    (4, 9, 16, 80),
    (4, 17, 16, 80),
    (4, 33, 16, 80),
    (4, 64, 8, 80),
    (4, 65, 8, 80),
    (4, 67, 16, 80),
    (2, 128, 8, 80),
    (2, 129, 8, 80),
    (3, 13, 12, 80),
    (2, 9, 6, 80),
]
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
    *H80_EDGES,
]
# K1 with Sq != Sk, (q shape, Sk): one tile per head both ways (and one
# query row against 65 keys at head_dim 128); packed
# tiles with Sq > Sk (4 and 8 heads, the second 8 of H = 12 part empty)
# and Sq < Sk (2 heads); head_dim 80 both ways (67 queries against a
# ragged 13-key tile, 13 against a 64-key tile and a 3-key one)
CROSS_SHAPES = [
    ((2, 40, 4, 64), 130),
    ((4, 13, 16, 64), 52),
    ((2, 199, 4, 32), 7),
    ((4, 13, 16, 64), 7),
    ((4, 1, 16, 64), 20),
    ((2, 5, 12, 32), 3),
    ((2, 1, 8, 128), 65),
    ((2, 67, 16, 80), 13),
    ((2, 13, 16, 80), 67),
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
# K2/K3 shapes: the training slice's, ViT-B, 448 px, ViT-H/14 (head_dim
# 80), head_dim 128; then every tile edge of the wgmma kernels, which
# tile and pack as K1 does: rows and keys around
# the 64-row tiles (64/65, 128/129); S = 1, 8/9, 13, 16/17, 32/33 at H = 16
# on the edges of the heads-per-tile rule (16, 8, 4, 2, 1 heads), with
# H = 12 and 6 leaving the last packed tile part empty; the ring hop;
# head_dims 32 and 128 packed and ragged; head_dim 80's edges (H80_EDGES).
# Sq != Sk: K1's CROSS_SHAPES.
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
    *H80_EDGES,
]


T_IMPORT = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, with the seconds since this module was
    imported (where the run's time goes, read off its log)."""
    print(f"[chip_smoke {time.perf_counter() - T_IMPORT:.1f}s] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"[chip_smoke {time.perf_counter() - T_IMPORT:.1f}s] FAIL: {what}")


# the child processes of phases that run beside others: killed by
# :func:`kill_children` when the run ends before they do
LIVE_CHILDREN: set = set()


def kill_children() -> None:
    for proc in list(LIVE_CHILDREN):
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    LIVE_CHILDREN.clear()


class Background:
    """``fn(*args)`` on a thread of its own while the caller runs other
    phases; :meth:`join` waits for it and gives its result, or raises its
    failure (a failed ``check`` included). Its phases run only child
    processes, so the launch counters of this process stay the caller's."""

    def __init__(self, fn, *args):
        self.t0 = time.perf_counter()
        self.seconds = self.waited_s = 0.0
        self._box: dict = {}
        self._thread = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self._thread.start()

    def _run(self, fn, args) -> None:
        try:
            self._box["result"] = fn(*args)
        except BaseException as exc:  # noqa: BLE001 - a failed check is a SystemExit, raised again by join()
            self._box["error"] = exc
        self.seconds = time.perf_counter() - self.t0

    def join(self):
        t0 = time.perf_counter()
        self._thread.join()
        self.waited_s = time.perf_counter() - t0
        if "error" in self._box:
            raise self._box["error"]
        return self._box["result"]


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
    # strided inputs: q, k, v as views of one fused (B, S, 3, H, D)
    # projection (head_dim 80: 160-byte rows, two tensor maps a view)
    for b, s, h, d in (VIT_B_SHAPE, (64, 67, 16, 80)):
        fused = torch.randn((b, s, 3, h, d), device="cuda").to(torch.bfloat16)
        q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
        o = fa.flash_attention_fwd(q, k, v)
        ref = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
        check(torch.equal(o, ref), f"strided q/k/v views disagree with contiguous copies at head_dim {d}")
    log("kernel on strided q/k/v views equals contiguous copies (head_dims 64, 80): True")
    # pad rows are inert at the finetune shape and the ViT-H/14 encoder's:
    # NaN stored past the sequence in the same buffers is never read
    for shape in (FT_SHAPE, (64, 67, 16, 80), (8, 13, 16, 80)):
        q, k, v = qkv(shape, torch.bfloat16, seed=77)
        ref, ref_lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        padded = []
        for x in (q, k, v):
            buf = torch.full((shape[0], shape[1] + 57, *shape[2:]), float("nan"), dtype=x.dtype, device="cuda")
            buf[:, : shape[1]] = x
            padded.append(buf[:, : shape[1]])
        o, lse = fa.flash_attention_fwd(*padded, with_lse=True)
        check(torch.equal(o, ref) and torch.equal(lse, ref_lse), f"pad rows change K1's output at {shape}")
        log(f"kernel at {shape} with NaN past the sequence equals the contiguous run: True")
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


def phase_timings(fa, shapes=None, f32: bool = True) -> dict:
    """Phase 5a: K1 in bf16 at the main paths' shapes (ViT-B serving; the
    MAE decoder and encoder, the ring hop and the finetune batch, with lse,
    as training calls it; the served reconstruction's encoder and decoder
    at bucket 64) and at 448 px: device time per call from CUDA-graph replay
    (``ms``, the plain version, SDPA's forward) and from eager back-to-back
    launches (``eager_ms``, the method of the earlier kernels lines), the
    least time the card could take, and the wrapper's host µs per call;
    K1 in f32 at the ViT-B shape. ``shapes``: other (shape, with lse)
    pairs instead (phase 25's), ``f32=False`` leaves the f32 time out."""
    import torch
    import torch.nn.functional as F

    out = {}
    shapes = shapes or ((VIT_B_SHAPE, False), (DEC_SHAPE, True), (ENC_SHAPE, True), (HOP_SHAPE, True),
                        ((4, 787, 16, 64), False), (FT_SHAPE, True), (RECON_ENC_SHAPE, False),
                        (RECON_DEC_SHAPE, False))
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
    if f32:
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


def k3_wgmma_at_80(fa) -> bool:
    """Whether the package's K3 at head_dim 80 is the wgmma kernel (this
    checkout) or the mma.sync one (an older checkout, as
    scripts/torch_k1_bench.py --base loads one)."""
    rule = fa.TMA_HEAD_DIMS
    return isinstance(rule, dict) and 80 in rule["K3"]


def k2_wgmma_at_80(fa) -> bool:
    """Whether the package's K2 at head_dim 80 is the wgmma kernel (this
    checkout) or the mma.sync one (an older checkout, as
    scripts/torch_k1_bench.py --base loads one)."""
    rule = fa.TMA_HEAD_DIMS
    return isinstance(rule, dict) and 80 in rule["K2"]


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

    for b, s, h, d in (VIT_B_SHAPE, (64, 67, 16, 80)):
        fused = torch.randn((b, s, 5, h, d), device="cuda").to(torch.bfloat16)
        q, k, v, do, o_view = (fused[:, :, i] for i in range(5))
        o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        o_view.copy_(o)
        got = kernel_bwd(fa, q, k, v, o_view, lse, do)
        ref = kernel_bwd(fa, *(x.contiguous() for x in (q, k, v, o)), lse, do.contiguous())
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"K2/K3 on strided views differ from contiguous copies at head_dim {d}")
    log("K2/K3 on strided q/k/v/dO/O views equal contiguous copies (head_dims 64, 80): True")

    # broadcast views (stride 0, which no TMA tensor map describes): dO of
    # o.sum() and k, v shared over the batch give the gradients of their
    # contiguous copies
    for shape in (DEC_SHAPE, HOP_SHAPE, (2, 70, 4, 128), (2, 67, 4, 80), (4, 9, 16, 80)):
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
                      (2, 9, 12, 32), (4, 67, 16, 80), (4, 13, 16, 80)):
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
        if k3_wgmma_at_80(fa):
            want[("K3", 80)] = 3
        if k2_wgmma_at_80(fa):
            want[("K2", 80)] = 3
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


def phase_bwd_timings(fa, k1_timings: dict | None = None, shapes=None, fb_shapes=None) -> dict:
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
    result) and is left out without it. ``shapes`` and ``fb_shapes``:
    other shapes for the kernels and for ``FlashAttention`` (phase 25's)."""
    import torch
    import torch.nn.functional as F

    k1_timings = k1_timings or {}
    folds = folds_delta(fa)

    def einsum_path(q, k, v):  # models/layers.py's einsum branch
        probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k).float(), dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    out = {}
    shapes = shapes or (ENC_SHAPE, DEC_SHAPE, HOP_SHAPE, FT_SHAPE)
    fb_shapes = fb_shapes or (ENC_SHAPE, DEC_SHAPE, FT_SHAPE)
    for shape in shapes:
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
        if shape in fb_shapes:
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


def phase_slice(fa, smi: str, recipe: str, device: str = "cuda") -> tuple[int, int]:
    """Phase 6: the serving slice on the model of ``recipe`` (random
    weights from its ``run.init_seed``). Returns (launches, dispatches)
    of the main-path run."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.cli import predict
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
    from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images

    t0 = time.perf_counter()
    engine = InferenceEngine(load_config(HERE / recipe), max_batch=64, device=device)
    model = engine.model("logits")
    cfg = model.cfg
    nparams = sum(p.numel() for p in model.parameters())
    log(f"engine built in {time.perf_counter() - t0:.2f} s: {nparams} params, "
        f"seq {cfg.num_cls_tokens + cfg.num_patches}, {cfg.dtype}")
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
    captures = sum(engine.compile_counts.values())
    for (what, n), out in outs.items():
        check(out.shape == (n, widths[what]) and out.dtype == np.float32,
              f"{what} for {n} images has shape {out.shape} {out.dtype}")
        check(bool(np.isfinite(out).all()), f"{what} for {n} images is not finite")
    want = sum(-(-n // 64) for n in REQUESTS) * 3
    # every dispatch replays a graph; each capture ran its forward once
    # eagerly first, so K1 ran layers x (dispatches + captures) times
    log(f"main path: {dispatches} dispatches (expected {want}) through {captures} captured graphs, "
        f"{launches} flash launches ({layers} x (dispatches + captures) = {layers * (dispatches + captures)})")
    check(dispatches == want, "dispatch count")
    check(launches == layers * (dispatches + captures), "flash launches != layers x (dispatches + captures)")
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
    log(f"throughput: {64 * reps / dt:.1f} images/s (logits, bucket 64, {cfg.dtype}, "
        f"host clock incl. upload and fetch) on {smi}")
    with torch.inference_mode():
        xn = normalize_images(torch.from_numpy(batch).to(engine.device), dtype=cfg.compute_dtype)
        fwd_ms = cuda_ms(lambda: model(xn), iters=10, warmup=2)
    log(f"device forward, bucket 64: {fwd_ms:.3f} ms ({64e3 / fwd_ms:.1f} images/s); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del engine, model

    # ---- cli.predict, the user's entry point: 8 images, one dispatch (its
    # graph's eager first run, then the replay)
    before = fa.LAUNCHES
    predict.main(["--config", str(HERE / recipe), "--task", "logits", "--synthetic", "8", "--max-batch", "64"])
    check(fa.LAUNCHES - before == 2 * layers, f"cli.predict made {fa.LAUNCHES - before} launches, want {2 * layers}")
    log(f"cli.predict served 8 images through {2 * layers} kernel launches (a capture's first run and a replay)")

    # ---- float32 on the card against float32 on the CPU, same weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev32 = InferenceEngine(load_config(HERE / recipe), dtype="float32", max_batch=64, device=device)
    cpu32 = InferenceEngine(load_config(HERE / recipe), dtype="float32", max_batch=64, device="cpu")
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
    diag = train_diag(fa, smi, batch, vals, state, step_ms)
    return dict(counts=counts, step_ms=step_ms, images_per_s=ips, mfu=util, peak_gib=peak_gib, diag=diag)


DIAG_NORM_RTOL = 1e-5  # the group norms against a float64 recomputation from the same tensors
DIAG_RATIO_RTOL = 1e-4  # the update ratio: a quotient of two such norms
DIAG_TURN_PAIRS = 10  # (plain, diag, diag, plain), ten times


def train_diag(fa, smi: str, batch, plain_losses: list[float], plain_state, plain_ms: float) -> dict:
    """Phase 7b: the same 3 + 10 ViT-L/16 steps with ``diag=True`` (every
    step a diag step), from a state built from phase 7's seeds (a copy kept
    on the card would count in phase 7's peak memory): losses and
    parameters bit-equal to phase 7's, K1 56 and K2 = K3 32 a step, the
    step's ms beside phase 7's, then 40 plain and diag steps of one state in
    turns (plain, diag, diag, plain, ...); then one more diag step whose ``(29, 3)``
    array is held against a float64 recomputation from the same old
    parameters, gradients (captured as the optimizer receives them) and new
    parameters, and the device ms of the parameter copy and of
    ``group_stats`` alone."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.obs.modelstats import group_layout, group_of, group_stats
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step

    enc, dec, opt = vit_l16_mae()
    state = create_state((enc, dec, True), opt, device="cuda", init_seed=0, rng_seed=0, global_batch_size=TRAIN_BATCH)
    step = make_train_step(mode="pretrain", diag=True)
    layout = group_layout(state.model)
    fa.LAUNCHES = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = 0
    losses, arrays = [], []
    for _ in range(WARMUP_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
        arrays.append(m["diag"])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TIMED_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
        arrays.append(m["diag"])
    end.record()
    torch.cuda.synchronize()
    counts = {"K1": fa.LAUNCHES, "K2": fa.LAUNCHES_BWD_DQ, "K3": fa.LAUNCHES_BWD_DKV}
    steps = WARMUP_STEPS + TIMED_STEPS
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    vals = [x.item() for x in losses]
    check(len(layout) == 29 and all(a.shape == (29, 3) for a in arrays), f"diag: groups {layout}")
    check(counts == {"K1": 56 * steps, "K2": 32 * steps, "K3": 32 * steps}, f"diag: launches {counts}")
    check(vals == plain_losses, f"diag: losses {vals} against phase 7's {plain_losses}")
    same = all(torch.equal(a, b) for a, b in zip(state.model.parameters(), plain_state.model.parameters(),
                                                   strict=True))
    check(same, "diag: the parameters after 13 diag steps differ from phase 7's")
    finite = torch.stack(arrays).isfinite().all().item()
    check(finite, "diag: a non-finite group statistic on a clean run")
    log(f"diag: {steps} ViT-L/16 steps with diag=True: losses and parameters bit-equal to phase 7's, launches "
        f"K1 {counts['K1']}, K2 {counts['K2']}, K3 {counts['K3']}; {step_ms:.2f} ms a step against phase 7's "
        f"{plain_ms:.2f} ms (CUDA events over {TIMED_STEPS} steps), on {smi}")
    del plain_state
    # the diag's cost on the step: one state stepped with and without it in
    # turns (plain, diag, diag, plain, ...), each step between two CUDA
    # events on the stream, read after one synchronisation
    plain = make_train_step(mode="pretrain")
    order = [name for _ in range(DIAG_TURN_PAIRS) for name in ("plain", "diag", "diag", "plain")]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(order) + 1)]
    marks[0].record()
    for name, mark in zip(order, marks[1:]):
        state, m = (plain if name == "plain" else step)(state, batch)
        mark.record()
    torch.cuda.synchronize()
    turns = {"plain": [], "diag": []}
    for name, a, b in zip(order, marks, marks[1:]):
        turns[name].append(a.elapsed_time(b))
    q = {k: np.percentile(v, [25, 50, 75]).tolist() for k, v in turns.items()}
    log(f"diag: ms a step in turns ({len(order)} steps: plain, diag, diag, plain, ...): plain quartiles {q['plain']}, "
        f"diag {q['diag']}: median +{q['diag'][1] - q['plain'][1]:.2f} ms a diag step, on {smi}")

    # one more step, the optimizer's gradients captured as it receives them
    captured = {}
    update = state.tx.update

    def capture(opt_state, params, grads):
        captured["grads"] = [g.detach().clone() for g in grads]
        return update(opt_state, params, grads)

    params = list(state.model.parameters())
    old = [p.detach().clone() for p in params]
    state.tx.update = capture
    try:
        state, m = step(state, batch)
    finally:
        del state.tx.update
    got = m["diag"].double().cpu().numpy()
    new, grads = [p.detach() for p in params], captured["grads"]
    names = [n for n, _ in state.model.named_parameters()]
    sums = torch.zeros((len(layout), 3), dtype=torch.float64, device="cuda")
    for n, o, g, p in zip(names, old, grads, new, strict=True):
        row = layout.index(group_of(n))
        sums[row, 0] += g.double().square().sum()
        sums[row, 1] += o.double().square().sum()
        sums[row, 2] += (p.float() - o.float()).double().square().sum()
    norms = sums.sqrt().cpu().numpy()
    want = np.stack([norms[:, 0], norms[:, 1], norms[:, 2] / (norms[:, 1] + 1e-12)], axis=1)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    err = {k: float(rel[:, i].max()) for i, k in enumerate(("grad_norm", "param_norm", "update_ratio"))}
    log(f"diag: the (29, 3) array against a float64 recomputation from the same tensors: largest relative "
        f"error {err}; blocks.0 {dict(zip(('grad', 'param', 'ratio'), got[layout.index('blocks.0')].tolist()))}")
    check(err["grad_norm"] <= DIAG_NORM_RTOL and err["param_norm"] <= DIAG_NORM_RTOL
          and err["update_ratio"] <= DIAG_RATIO_RTOL, f"diag: the array against its recomputation {err}")
    copy_ms = cuda_ms(lambda: torch._foreach_mul(new, 1.0), iters=10, warmup=2)
    stats_ms = cuda_ms(lambda: group_stats(old, grads, new, names=names), iters=10, warmup=2)
    # its parts: one foreach norm over the parameters, the difference; and
    # the host ms to enqueue one call (the device idle from a synchronise)
    norm_ms = cuda_ms(lambda: torch._foreach_norm(new), iters=10, warmup=2)
    sub_ms = cuda_ms(lambda: torch._foreach_sub(new, old), iters=10, warmup=2)
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        group_stats(old, grads, new, names=names)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    enqueue_ms = float(np.median(enqueue))
    gb = sum(p.numel() * p.element_size() for p in new) / 1e9
    log(f"diag: device ms a diag step: the parameter copy {copy_ms:.3f} ({2e3 * gb / copy_ms:.0f} GB/s), "
        f"group_stats {stats_ms:.3f} ({sum(p.numel() for p in new)} parameters, {gb:.2f} GB, in {len(layout)} "
        f"groups): a foreach norm {norm_ms:.3f} ({1e3 * gb / norm_ms:.0f} GB/s), the difference {sub_ms:.3f}; "
        f"the host enqueues one group_stats call in {enqueue_ms:.3f} ms, on {smi}")
    res = dict(step_ms=step_ms, plain_step_ms=plain_ms, turn_quartiles=q, counts=counts, max_rel_err=err,
               copy_ms=copy_ms, stats_ms=stats_ms, norm_ms=norm_ms, sub_ms=sub_ms, enqueue_ms=enqueue_ms,
               groups=len(layout))
    del state, old, grads, captured
    return res


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

    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
    from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step

    # recipes/smoke_cpu.yaml's vit_t16 (32 px, patch 4, sincos2d) in bf16
    recipe = load_config(HERE / "recipes" / "smoke_cpu.yaml", ["model.overrides.dtype=bfloat16"])
    engine = InferenceEngine(recipe, labels=10, max_batch=8, device="cuda")
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
def instrumented_driver(fa, before_step=None, keep_images: bool = True):
    """Record what one ``cli.train.main`` run does, without changing it:
    every host batch the loader hands out (in order; hashed into
    ``digests`` after the run, off the timed path; ``keep_images=False``
    keeps none, for a run whose resident set is measured), the host seconds of
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
           "evals": [], "saves": [], "restores": [], "ckpt": None}
    saved = (TrainLoader.__next__, cli.make_train_step, engine_mod.fetch_metrics, cli.evaluate, Checkpointer.save,
             Checkpointer.restore)
    next_batch, make_step, fetch, evaluate, save, restore = saved

    def loader_next(self):
        t0 = time.perf_counter()
        batch = next_batch(self)
        rec["loader_wait_s"].append(time.perf_counter() - t0)
        if keep_images:
            rec["images"].append(batch["images"])  # a reference: the prefetch copies, nothing writes it
        return batch

    def make_train_step(**kw):
        step = make_step(**kw)

        def timed(state, batch, *inject, **kw):
            if before_step is not None:
                before_step(len(rec["dispatch_s"]))
            t0 = time.perf_counter()
            out = step(state, batch, *inject, **kw)
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
        rec["evals"].append(out)
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


def run_driver(fa, argv: list[str], *, keep_state_at: int | None = None, before_step=None,
               keep_images: bool = True) -> dict:
    """One ``cli.train.main(argv)`` run with the launch counts set to 0 just
    before and read just after. ``keep_state_at``: keep a host copy of the
    state saved at that step (for the resume check); ``before_step`` and
    ``keep_images``: as :func:`instrumented_driver`'s."""
    from jumbo_mae_tpu_tpu_torch.cli import train as cli
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import host_state

    with instrumented_driver(fa, before_step, keep_images) as rec:
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


# phase 13's toy shards, written by a child process started at the top of
# the run (the writing is host work that the kernel phases leave idle)
SHARDS_CODE = ("import json, sys, time\n"
               "from jumbo_mae_tpu_tpu_torch.data.toy import write_toy_shards\n"
               "t0 = time.perf_counter()\n"
               "urls = write_toy_shards(sys.argv[1], image_size=224, n_train=1024, n_val=256, shard_size=256)\n"
               "print(json.dumps({'urls': urls, 'seconds': time.perf_counter() - t0}), flush=True)\n")


def start_shards(tmp: Path) -> dict:
    """Phase 13's toy shards (1024 train, 256 valid images at 224 px, 256 a
    shard), started: written into ``tmp/shards`` by a child process."""
    proc = subprocess.Popen([sys.executable, "-c", SHARDS_CODE, str(tmp / "shards")], cwd=HERE,
                            stdout=subprocess.PIPE, text=True)
    LIVE_CHILDREN.add(proc)
    return {"proc": proc, "t0": time.perf_counter()}


def finish_shards(started: dict, timeout_s: float = 300.0) -> dict:
    """The shards' URLs, once the child that writes them has ended."""
    proc = started["proc"]
    t0 = time.perf_counter()
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        LIVE_CHILDREN.discard(proc)
    check(proc.returncode == 0, f"driver: the shard writer exited {proc.returncode}")
    res = json.loads(out.strip().splitlines()[-1])
    log(f"driver: toy shards (1024 train, 256 valid, 224 px PNG) written in {res['seconds']:.1f} s by a child "
        f"process beside phases 2-12; waited for it {time.perf_counter() - t0:.1f} s")
    return res["urls"]


def phase_driver(fa, smi: str, tmp: Path, train_step_ms: float, shards: dict) -> dict:
    """Phase 13: ViT-L/16 MAE pretraining from its recipe through the CLI's
    ``main`` in this process, on toy shards at 224 px (1024 train, 256
    valid images, 256 per shard; ``shards`` from :func:`start_shards`): 4
    worker interpreters, the CUDA-stream prefetch, a sanity eval, 6 steps,
    the final eval and the checkpoint."""
    import numpy as np

    from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer

    urls = finish_shards(shards)
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
        data_wait_s_per_step=summary["data/wait_s_per_step"],
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
               mfu=summary["perf/mfu"], data_wait_s_per_step=summary["data/wait_s_per_step"],
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


def start_toy_proof(tmp: Path) -> dict:
    """Phase 18, started: the toy pretrain-then-probe proof on the card,
    with the JAX test's gates (:func:`finish_toy_proof`).

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
    started = {"procs": procs, "dirs": dirs, "t0": time.perf_counter(), "ends": {}}

    def stamp(i: int, proc: subprocess.Popen) -> None:  # each exit's time, however late the reaping
        proc.wait()
        started["ends"][i] = time.perf_counter()

    for i, proc in enumerate(procs):
        threading.Thread(target=stamp, args=(i, proc), daemon=True).start()
    return started


def finish_toy_proof(smi: str, started: dict) -> dict:
    """Phase 18, reaped: the pretrained probe beats the random one by more
    than 0.1, and by more than 1.5x, and reads above 0.25."""
    procs, dirs = started["procs"], started["dirs"]
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
    ends = started["ends"]
    res["seconds"] = (max(ends.values()) if len(ends) == len(procs) else time.perf_counter()) - started["t0"]
    return res

SERVE_IMAGES = 70


def _serve_files(urls: dict, out: Path, n: int = SERVE_IMAGES) -> list[str]:
    """The first ``n`` PNGs of phase 13's first validation shard, written
    out as image files (their bytes as the shard holds them)."""
    import tarfile

    out.mkdir(parents=True, exist_ok=True)
    files = []
    with tarfile.open(urls["val"].split("{", 1)[0] + "0000.tar") as tar:
        for m in tar.getmembers():
            if m.name.endswith(".png") and len(files) < n:
                f = out / Path(m.name).name
                f.write_bytes(tar.extractfile(m).read())
                files.append(str(f))
    check(len(files) == n, f"phase 13's validation shard gave {len(files)} images, want {n}")
    return files


@contextlib.contextmanager
def recorded_engines():
    """Record every engine ``cli.predict`` builds, without changing it."""
    from jumbo_mae_tpu_tpu_torch.cli import predict

    made = []
    real = predict.InferenceEngine

    class Recorded(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    predict.InferenceEngine = Recorded
    try:
        yield made
    finally:
        predict.InferenceEngine = real


def cli_predict(fa, argv: list[str]) -> dict:
    """One ``cli.predict.main(argv)`` in this process, K1's count set to 0
    just before and read just after; its stdout, ``.npz``, engine and
    seconds."""
    import io

    import numpy as np

    from jumbo_mae_tpu_tpu_torch.cli import predict

    buf = io.StringIO()
    with recorded_engines() as made, contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        fa.LAUNCHES = 0
        out = predict.main(argv)
        k1 = fa.LAUNCHES
        wall = time.perf_counter() - t0
    (engine,) = made
    return {"k1": k1, "out": dict(np.load(out)), "stdout": buf.getvalue(), "engine": engine, "wall_s": wall}


def ran(engine) -> int:
    """Forwards an engine ran on the card: one replay a dispatch, and one
    eager first run before each capture."""
    return engine.dispatches + sum(engine.compile_counts.values())


def bucket_timings(engine, images, task: str = "logits", reps: int = 10) -> dict:
    """Host-clock ms per dispatch (upload, forward, fetch) and images/s of
    ``task`` at buckets 1, 8 and 64, after one warm call each."""
    out = {}
    for b in (1, 8, 64):
        batch = images[:b]
        engine.predict(batch, task=task)
        compute = 0.0
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.predict(batch, task=task)
            compute += engine.last_breakdown()["compute_s"]
        ms = (time.perf_counter() - t0) / reps * 1e3
        out[b] = {"ms": ms, "images_per_s": b / ms * 1e3, "compute_ms": compute / reps * 1e3}
    return out


def phase_serve_saves(fa, smi: str, tmp: Path, urls: dict) -> dict:
    """Phase 19: serving the saves of phases 13, 16 and 17 from their
    recipes through ``cli.predict.main`` in this process, on 70 image
    files written from phase 13's validation shard. Gates: ViT-B/16 logits
    from the finetune ``best`` with K1 = 12 a forward, one JSON line an
    image, within bf16 relative error 1e-2 of the classifier
    ``Checkpointer.restore_eval`` restores, top-1 identical; features and
    int8 of that save with the package's parity gates; the ViT-L/16 linear
    probe with K1 = 24 x dispatches and the save's BatchNorm statistics
    bit-equal in the engine; the ViT-L/16 reconstruction with K1 = 32 a
    dispatch, 147 of 196 patches masked, and with the encoder cache twice:
    the second call all hits and 8 K1 a decode dispatch, both bit-equal to
    the fused path; ``--serve`` within bf16 tolerance of the direct path;
    the float32 engine on the card against the CPU's. Logs restore
    seconds and bytes, images/s and ms a dispatch at buckets 1, 8 and 64
    (bf16 and int8), the reconstruction cold and warm, and the warmup."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.cli.predict import load_image
    from jumbo_mae_tpu_tpu_torch.cli.train import build_model
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine, parity_report
    from jumbo_mae_tpu_tpu_torch.infer.quant import FEATURE_COSINE_MIN, TOP1_AGREEMENT_MIN
    from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer, restore_inference_state
    from jumbo_mae_tpu_tpu_torch.train.optim import Identity
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state

    t_start = time.perf_counter()
    out_dir = tmp / "serve"
    files = _serve_files(urls, out_dir / "images")
    n = len(files)
    dispatches = -(-n // 64)  # a 64-image bucket and an 8-image one
    ft = tmp / "ft" / "finetune_vit_b16" / "ckpt"
    lin = tmp / "lin" / "linear_lars_vit_l16" / "ckpt"
    mae = tmp / "a" / "pretrain_vit_l16_in1k_800ep" / "ckpt"
    ft_cfg = load_config(HERE / FT_RECIPE)
    images = np.stack([load_image(f, 224, ft_cfg.data.test_crop_ratio) for f in files])
    res: dict = {"images": n, "restore": {}}
    serve_k1 = 0

    def restored(name: str, engine, task: str) -> None:
        res["restore"][name] = {"s": engine.restore_s, "bytes": engine.restore_bytes, "build_s": engine.build_s[task]}
        log(f"serve: restored {name}: {engine.restore_bytes} bytes mapped in {engine.restore_s:.3f} s, the {task} "
            f"model built and the save read into it in {engine.build_s[task]:.3f} s, on {smi}")

    # ---- 1. ViT-B/16 logits from the finetune best
    b16 = ["--config", str(HERE / FT_RECIPE), "--ckpt", str(ft), "--images", *files, "--max-batch", "64"]
    r = cli_predict(fa, [*b16, "--task", "logits", "--out", str(out_dir / "b16_logits.npz")])
    e1 = r["engine"]
    serve_k1 += r["k1"]
    restored("ViT-B/16 finetune best", e1, "logits")
    lines = [json.loads(x) for x in r["stdout"].splitlines() if x.startswith('{"image"')]
    check([x["image"] for x in lines] == files and all(len(x["classes"]) == 5 for x in lines),
          f"serve: {len(lines)} JSON lines for {n} images")
    logits = r["out"]["logits"]
    check(logits.shape == (n, 1000) and bool(np.isfinite(logits).all()), f"serve: logits {logits.shape}")
    check(e1.dispatches == dispatches and r["k1"] == 12 * ran(e1),
          f"serve: ViT-B/16 logits made {r['k1']} K1 launches in {e1.dispatches} dispatches, want 12 a dispatch "
          "and 12 a capture's first run")
    model, enc, _ = build_model(ft_cfg, device="cuda")
    state = create_state(model, Identity(ft_cfg.optim.param_dtype), device="cuda", init_seed=ft_cfg.run.init_seed)
    state, _ = Checkpointer(CheckpointConfig(str(ft))).restore_eval(state, which="best")
    with torch.inference_mode():
        x = normalize_images(torch.from_numpy(images).cuda(), dtype=enc.compute_dtype)
        ref = np.concatenate([state.model.model(x[i : i + 64]).float().cpu().numpy() for i in range(0, n, 64)])
    del model, state
    rel = float(np.linalg.norm(logits - ref) / np.linalg.norm(ref))
    top1 = bool(np.array_equal(logits.argmax(-1), ref.argmax(-1)))
    log(f"serve: ViT-B/16 logits of {n} files, {r['k1']} K1 in {e1.dispatches} dispatches, {len(lines)} JSON lines; "
        f"against restore_eval's classifier: relative error {rel:.3e}, max abs {np.abs(logits - ref).max():.3e}, "
        f"top-1 identical {top1}")
    check(rel <= 1e-2 and top1, f"serve: logits against restore_eval's classifier, relative error {rel:.3e}")
    res["b16_logits"] = {"k1": r["k1"], "dispatches": e1.dispatches, "rel_err": rel, "wall_s": r["wall_s"]}

    # ---- 2. the same save as features and as int8
    r = cli_predict(fa, [*b16, "--task", "features", "--pool", "cls", "--out", str(out_dir / "b16_feats.npz")])
    serve_k1 += r["k1"]
    e2 = r["engine"]
    feats = r["out"]["features"]
    check(feats.shape == (n, 3 * 768) and bool(np.isfinite(feats).all()) and r["k1"] == 12 * ran(e2),
          f"serve: features {feats.shape}, {r['k1']} K1 in {e2.dispatches} dispatches")
    r = cli_predict(fa, [*b16, "--task", "logits", "--quant", "int8", "--out", str(out_dir / "b16_int8.npz")])
    serve_k1 += r["k1"]
    e3 = r["engine"]
    check(r["k1"] == 12 * ran(e3), f"serve: int8 logits made {r['k1']} K1 in {e3.dispatches} dispatches")
    pf = parity_report(e2, e3, images, task="features", pool="cls")
    pl = parity_report(e1, e3, images, task="logits")
    qrep = e3.quant_reports["logits"]
    log(f"serve: int8 parity features {json.dumps(pf)}; logits {json.dumps(pl)}; compression "
        f"{qrep['compression']}, int8 weights on the card {qrep['int8_bytes']} bytes (f32 {qrep['bytes_before']})")
    check(pf["cosine_min"] >= FEATURE_COSINE_MIN and pl["top1_agreement"] >= TOP1_AGREEMENT_MIN,
          "serve: int8 parity gates")
    res["int8"] = {"features": pf, "logits": pl, "compression": qrep["compression"], "int8_bytes": qrep["int8_bytes"]}
    res["buckets"] = {"bf16": bucket_timings(e1, images), "int8": bucket_timings(e3, images)}
    for dt, t in res["buckets"].items():
        log(f"serve: ViT-B/16 logits {dt}: " + ", ".join(
            f"bucket {b} {v['ms']:.3f} ms a dispatch ({v['compute_ms']:.3f} until synced), {v['images_per_s']:.1f} images/s"
            for b, v in t.items()) + f", on {smi}")
    before = sum(e1.compile_counts.values())
    first = e1.warmup(("logits",))
    res["warmup_s"] = e1.warmup_s
    log(f"serve: warmup of the logits ladder {sorted({b for _, b in e1.compile_counts})}: {first} captures "
        f"(after {before}) in {e1.warmup_s:.3f} s, on {smi}")

    # ---- 5. --serve: single-image submits through the MicroBatcher
    r = cli_predict(fa, [*b16, "--task", "logits", "--serve", "--max-delay-ms", "5", "--out",
                         str(out_dir / "b16_serve.npz")])
    sizes = next(x for x in r["stdout"].splitlines() if "micro-batch sizes" in x).split(": ", 1)[1]
    served = r["out"]["logits"]
    rel_s = float(np.linalg.norm(served - logits) / np.linalg.norm(logits))
    log(f"serve: --serve batch sizes {sizes}; rows against the direct path: relative error {rel_s:.3e}, "
        f"top-1 agreement {float((served.argmax(-1) == logits.argmax(-1)).mean()):.4f}, {r['k1']} K1")
    check(rel_s <= 1e-2 and served.shape == logits.shape, f"serve: --serve rows, relative error {rel_s:.3e}")
    res["serve"] = {"batch_sizes": sizes, "rel_err": rel_s}

    # ---- 3. the ViT-L/16 linear probe with its BatchNorm statistics
    r = cli_predict(fa, ["--config", str(HERE / LINEAR_RECIPE), "--ckpt", str(lin), "--images", *files,
                         "--max-batch", "64", "--task", "logits", "--out", str(out_dir / "l16_logits.npz")])
    serve_k1 += r["k1"]
    e4 = r["engine"]
    restored("ViT-L/16 linear probe", e4, "logits")
    bn = e4.model("logits").head.bn
    stats = restore_inference_state(lin)[1]
    same = all(torch.equal(getattr(bn, k).cpu(), stats[f"model.head.bn.{k}"]) for k in ("running_mean", "running_var"))
    check(r["k1"] == 24 * ran(e4) and bool(np.isfinite(r["out"]["logits"]).all()) and same,
          f"serve: ViT-L/16 probe {r['k1']} K1 in {e4.dispatches} dispatches, BatchNorm statistics equal {same}")
    log(f"serve: ViT-L/16 linear probe logits, {r['k1']} K1 in {e4.dispatches} dispatches; the head's BatchNorm "
        f"statistics bit-equal to the save's")
    del e4

    # ---- 4. the ViT-L/16 reconstruction, fused, then the encoder cache
    mae_args = ["--config", str(HERE / RECIPE), "--ckpt", str(mae), "--images", *files, "--max-batch", "64",
                "--task", "reconstruct", "--seed", "3", "--out", str(out_dir / "recon.npz")]
    r = cli_predict(fa, mae_args)
    serve_k1 += r["k1"]
    e5 = r["engine"]
    restored("ViT-L/16 MAE", e5, "reconstruct")
    fused = r["out"]
    check(r["k1"] == 32 * ran(e5) and fused["reconstruction"].shape == (n, 196, 768)
          and bool((fused["mask"].sum(1) == 147).all()) and bool(np.isfinite(fused["reconstruction"]).all()),
          f"serve: reconstruction {r['k1']} K1 in {e5.dispatches} dispatches, masked per row "
          f"{sorted(set(fused['mask'].sum(1).tolist()))}")
    t0 = time.perf_counter()
    e5.reconstruct(images, seed=3)
    fused_ms = (time.perf_counter() - t0) * 1e3
    res["graphs"] = {"b16_logits": e1.graph_stats(), "l16_reconstruct": e5.graph_stats()}
    log(f"serve: graphs captured on demand (bucket 64 first: its pool growth is its own pool) — ViT-B/16 logits "
        f"{json.dumps(res['graphs']['b16_logits'])}; ViT-L/16 reconstruct {json.dumps(res['graphs']['l16_reconstruct'])}"
        f", on {smi}")
    del e5
    cached = InferenceEngine(load_config(HERE / RECIPE), ckpt=str(mae), max_batch=64, encoder_cache=128)
    # the model built and both halves run once at the request's buckets
    # (warmup leaves the cache empty): the cold call times the cache alone
    cached.warmup(("reconstruct",), buckets=(8, 64))
    calls = []
    for _ in range(2):
        fa.LAUNCHES, cached.dispatches = 0, 0
        t0 = time.perf_counter()
        got = cached.reconstruct(images, seed=3)
        calls.append({"ms": (time.perf_counter() - t0) * 1e3, "k1": fa.LAUNCHES, "dispatches": cached.dispatches,
                      **cached.encoder_cache_stats()})
        serve_k1 += fa.LAUNCHES
        check(np.array_equal(got["reconstruction"], fused["reconstruction"]) and np.array_equal(got["mask"], fused["mask"]),
              "serve: the cached reconstruction differs from the fused path")
    cold, warm = calls
    # cold: the encoder's 24 K1 and the decoder's 8 in each of their dispatches
    check(cold["k1"] == 32 * dispatches and cold["dispatches"] == 2 * dispatches and cold["misses"] == n,
          f"serve: cold cached call {cold}")
    check(warm["k1"] == 8 * warm["dispatches"] and warm["dispatches"] == dispatches and warm["hits"] == n,
          f"serve: warm cached call {warm}")
    log(f"serve: reconstruction fused {fused_ms:.1f} ms for {n} images; with the encoder cache cold {cold['ms']:.1f} "
        f"ms ({cold['k1']} K1), warm {warm['ms']:.1f} ms ({warm['k1']} K1 in {warm['dispatches']} decode dispatches, "
        f"{warm['hits'] - cold['hits']} hits), {warm['bytes']} bytes cached; both bit-equal to the fused path, on {smi}")
    res["reconstruct"] = {"fused_ms": fused_ms, "cold": cold, "warm": warm, "warmup_s": cached.warmup_s}
    del cached

    # ---- 6. the float32 engine on the card against the CPU's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = InferenceEngine(ft_cfg, ckpt=str(ft), dtype="float32", max_batch=64).logits(images[:4])
    c = InferenceEngine(ft_cfg, ckpt=str(ft), dtype="float32", max_batch=64, device="cpu").logits(images[:4])
    scale = float(np.abs(c).max())
    log(f"serve: f32 logits of the finetune save, card against CPU: max abs diff {np.abs(g - c).max():.3e}, "
        f"max |cpu| {scale:.3e}")
    np.testing.assert_allclose(g, c, rtol=1e-3, atol=1e-3 * scale)
    res["serve_launches"] = serve_k1
    res["seconds"] = time.perf_counter() - t_start
    log(f"serve: phase 19 in {res['seconds']:.1f} s, {serve_k1} K1 launches on its main paths")
    return res


PACK_MIX = "224:0.5,160:0.3,96:0.2"


def cli_predict_pool(fa, argv: list[str], beside=None) -> dict:
    """``cli.predict.main(argv)`` with replicas in this process, K1's count
    set to 0 just before and read just after; its stdout, ``.npz``, the
    engines it built and seconds. ``beside(stdout_so_far)`` runs on a
    thread of its own meanwhile (the pushes of a swap watch)."""
    import io

    import numpy as np

    from jumbo_mae_tpu_tpu_torch.cli import predict

    buf = io.StringIO()
    side = threading.Thread(target=beside, args=(buf.getvalue,), daemon=True) if beside else None
    with recorded_engines() as made, contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        fa.LAUNCHES = 0
        if side is not None:
            side.start()
        out = predict.main(argv)
        k1 = fa.LAUNCHES
        wall = time.perf_counter() - t0
    if side is not None:
        side.join(timeout=60)
    return {"k1": k1, "out": dict(np.load(out)), "stdout": buf.getvalue(), "engines": made, "wall_s": wall}


def wait_for(read, text: str, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while text not in read():
        check(time.monotonic() < deadline, f"no {text!r} in the CLI's output after {timeout_s} s")
        time.sleep(0.02)


def corrupt_copy(src: Path, dst: Path) -> None:
    """A committed save at ``dst`` whose model weights are ``src``'s
    scrambled (every matrix reversed along its first axis, times -3): it
    restores, grafts and serves, and its features point elsewhere."""
    import torch

    payload = torch.load(src / "state.pt", map_location="cpu", weights_only=True)
    payload["model"] = {k: -3.0 * v.flip(0) if v.is_floating_point() and v.dim() > 1 else v
                        for k, v in payload["model"].items()}
    dst.mkdir(parents=True)
    torch.save(payload, dst / "state.pt")
    shutil.copy2(src / "extra.json", dst / "extra.json")
    sizes = {name: (dst / name).stat().st_size for name in ("state.pt", "extra.json")}
    (dst / "COMMIT").write_text(json.dumps({"step": 0, "sizes": sizes}))


def timed_alternating(fns: dict, reps: int) -> dict:
    """Host-clock ms per call of each function, called in turns (a, b, b,
    a, ...) so a drift of the card's clocks falls on both; the median."""
    import numpy as np

    times: dict = {k: [] for k in fns}
    order = list(fns)
    for i in range(reps):
        for k in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            fns[k]()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def phase_replicated(fa, smi: str, tmp: Path, urls: dict) -> dict:
    """Phase 20: the replicated serving tier on phase 16's ViT-B/16
    finetune ``best`` and phase 19's PNG files. Each step sets K1's count
    to 0 just before it and reads it just after. Gates: every dispatch
    replays a graph; the ladder's captures counted in ``compile_counts``
    and flat over 50 requests and across ``swap_weights`` +
    ``restore_snapshot`` (the rollback bit-equal); K1 = 12 a replay, a
    profiler trace of one bucket-64 replay showing the K1 kernel 12 times;
    graph against eager at buckets 1, 8, 64 (top-1 identical, bf16
    relative error <= 1e-2); the packed mix's parity against the
    unpacked graphs (cosine >= 0.999 and top-1 1.0, in bf16 and in
    float32) with no K1 in packed or embed graphs;
    ``cli.predict --serve --replicas 2`` and ``--pack`` with a promoted
    push and a corrupt push rejected at parity, every request served."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jumbo_mae_tpu_tpu_torch.cli.predict import draw_sizes, load_image, parse_mix
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
    from jumbo_mae_tpu_tpu_torch.ops.preprocess import normalize_images
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import restore_inference_state

    t_start = time.perf_counter()
    res: dict = {}
    ft = tmp / "ft" / "finetune_vit_b16" / "ckpt"
    mae16 = tmp / "b16" / "pretrain_vit_b16_in1k_1600ep" / "ckpt"
    files = sorted(str(p) for p in (tmp / "serve" / "images").glob("*.png"))
    check(len(files) == SERVE_IMAGES, f"replicated: phase 19's {len(files)} files")
    cfg = load_config(HERE / FT_RECIPE)
    ratio = cfg.data.test_crop_ratio
    images = np.stack([load_image(f, 224, ratio) for f in files])

    # ---- 1. the ladder captured, bucket 64 first (its pool growth is its own pool)
    eng = InferenceEngine(cfg, ckpt=str(ft), max_batch=64)
    fa.LAUNCHES = 0
    captures = eng.warmup(("logits",), buckets=(64, 32, 16, 8, 4, 2, 1), workers=1)
    gs = eng.graph_stats()
    check(captures == 7 and fa.LAUNCHES == 12 * 2 * 7,
          f"replicated: warmup made {captures} captures and {fa.LAUNCHES} K1 (want 7 and 12 x 2 x 7)")
    check(all(v["launches"] == {"LAUNCHES": 12} for v in gs.values()), f"replicated: launches a replay {gs}")
    res["capture"] = {k: {x: v[x] for x in ("first_run_s", "capture_s", "pool_bytes")} for k, v in gs.items()}
    res["warmup_s"] = eng.warmup_s
    log(f"replicated: the logits ladder captured in {eng.warmup_s:.3f} s (the model's build included): "
        + ", ".join(f"{k} first run {v['first_run_s'] * 1e3:.1f} ms, capture {v['capture_s'] * 1e3:.1f} ms, "
                    f"pool +{v['pool_bytes'] / 2**20:.1f} MiB" for k, v in gs.items()) + f", on {smi}")

    # ---- 2. graph against eager: the same upload and fetch, buckets 1, 8, 64
    model = eng.model("logits")

    def eager(batch):
        with torch.inference_mode():
            x = torch.from_numpy(batch).cuda()
            return model(normalize_images(x, dtype=eng._enc.compute_dtype)).float().cpu().numpy()

    res["ladder"] = {}
    for b in (1, 8, 64):
        batch = images[:b]
        fa.LAUNCHES, eng.dispatches = 0, 0
        g = eng.logits(batch)
        k1 = fa.LAUNCHES
        check(eng.dispatches == 1 and k1 == 12, f"replicated: bucket {b} made {k1} K1 in {eng.dispatches} dispatches")
        e = eager(batch)
        rel = float(np.linalg.norm(g - e) / np.linalg.norm(e))
        top1 = bool(np.array_equal(g.argmax(-1), e.argmax(-1)))
        check(rel <= 1e-2 and top1, f"replicated: graph against eager at bucket {b}: relative error {rel:.3e}")
        ms = timed_alternating({"graph": lambda: eng.logits(batch), "eager": lambda: eager(batch)}, 20)
        res["ladder"][b] = {**ms, "rel_err": rel, "bit_equal": bool(np.array_equal(g, e)), "k1": k1}
        log(f"replicated: bucket {b}: graph {ms['graph']:.3f} ms a dispatch, eager {ms['eager']:.3f} ms (upload, "
            f"forward, fetch; medians of 20 in turns), {b / ms['graph'] * 1e3:.1f} images/s; graph against eager "
            f"relative error {rel:.3e}, bit-equal {np.array_equal(g, e)}, top-1 identical; {k1} K1, on {smi}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.logits(images[:64])
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    traced = sum(1 for n in names if "flash_fwd" in n)
    check(traced == 12, f"replicated: a bucket-64 replay's trace shows the K1 kernel {traced} times")
    res["trace_k1"] = traced
    log(f"replicated: torch.profiler trace of one bucket-64 replay: {traced} K1 kernels "
        f"({sorted({n for n in names if 'flash' in n})}), {len(names)} device events")

    # ---- 3. compile counts flat: 50 requests, then a swap and its rollback
    counts = dict(eng.compile_counts)
    rng = np.random.default_rng(20)
    fa.LAUNCHES, eng.dispatches = 0, 0
    for n in rng.integers(1, 65, 50):
        eng.logits(images[:n])
    check(eng.compile_counts == counts and fa.LAUNCHES == 12 * eng.dispatches == 12 * 50,
          f"replicated: 50 requests captured {eng.compile_counts} (was {counts}), {fa.LAUNCHES} K1")
    before = eng.logits(images)
    snap = eng.swap_weights(*restore_inference_state(mae16), ckpt=str(mae16))
    swapped = eng.logits(images)
    eng.restore_snapshot(snap)
    back = eng.logits(images)
    check(eng.compile_counts == counts, f"replicated: the swap captured {eng.compile_counts}")
    check(not np.array_equal(swapped, before) and np.array_equal(back, before),
          "replicated: the swap did not serve the new tree, or the rollback is not bit-equal")
    log(f"replicated: 50 requests (sizes 1-64) and a swap to phase 15's MAE encoder + rollback made no capture "
        f"({sum(counts.values())} graphs); the swap moved the logits, the rollback bit-equal to before")

    # ---- 4. the packed mix: parity, pad, ms a dispatch
    sizes = draw_sizes(parse_mix(PACK_MIX), len(files), np.random.RandomState(0))
    pim = [load_image(f, s, ratio) for f, s in zip(files, sizes)]
    lengths = [eng.seq_len(s) for s in sizes]
    fa.LAUNCHES = 0
    par_f = eng.packed_parity(pim, "features")
    par_l = eng.packed_parity(pim, "logits")
    k1_parity = fa.LAUNCHES
    pg = eng.graph_stats()
    no_k1 = all(not v["launches"] for k, v in pg.items() if ".packed:" in k or ".embed@" in k)
    check(no_k1 and all(v["launches"] == {"LAUNCHES": 12} for k, v in pg.items() if ".full:" in k),
          f"replicated: K1 in the packed path's graphs {pg}")
    check(par_f["feature_cosine_min"] >= 0.999 and par_l["logits_top1_agree"] == 1.0,
          f"replicated: packed parity features {par_f['feature_cosine_min']}, logits {par_l['logits_top1_agree']}")
    # one scheduler group: the requests whose tokens fill a 4096 budget
    group, tok = [], 0
    for im, n in zip(pim, lengths):
        if tok + n <= 4096:
            group.append(im)
            tok += n
    fa.LAUNCHES = 0
    eng.predict_packed(group, "logits")
    bd = eng.last_breakdown()
    k1_packed = fa.LAUNCHES
    check(k1_packed == 0, f"replicated: a packed dispatch launched K1 {k1_packed} times")

    def unpacked():  # the image-bucketed path: one dispatch per resolution
        by = {}
        for im in group:
            by.setdefault(im.shape[0], []).append(im)
        for res_ims in by.values():
            eng._reset_breakdown()
            eng._per_resolution(res_ims, "logits.full:cls")

    unpacked()
    ms = timed_alternating({"packed": lambda: eng.predict_packed(group, "logits"), "by_resolution": unpacked}, 10)
    f32 = InferenceEngine(cfg, ckpt=str(ft), max_batch=64, dtype="float32")
    par32 = f32.packed_parity(pim, ["logits", "features"] * (len(pim) // 2))
    check(par32["logits_top1_agree"] == 1.0 and par32["feature_cosine_min"] >= 0.999999,
          f"replicated: float32 packed parity {par32['logits_top1_agree']}, {par32['feature_cosine_min']}")
    res["packed"] = {"sizes": {s: sizes.count(s) for s in sorted(set(sizes))}, "tokens": sorted(set(lengths)),
                     "cosine_min": par_f["feature_cosine_min"], "top1": par_l["logits_top1_agree"],
                     "f32_top1": par32["logits_top1_agree"], "f32_cosine_min": par32["feature_cosine_min"],
                     "group": len(group), "group_tokens": tok, "budget": bd["bucket"],
                     "pad_fraction": bd["pad_fraction"], **{f"{k}_ms": v for k, v in ms.items()},
                     "k1_parity": k1_parity, "k1_packed": k1_packed}
    log(f"replicated: packed mix {res['packed']['sizes']} ({sorted(set(lengths))} tokens) of {len(pim)} files: "
        f"parity bf16 cosine_min {par_f['feature_cosine_min']:.6f}, top-1 {par_l['logits_top1_agree']:.4f}; f32 "
        f"top-1 {par32['logits_top1_agree']}, cosine_min {par32['feature_cosine_min']:.8f}; a {len(group)}-request "
        f"group ({tok} tokens) in a {bd['bucket']}-token rung, token pad {bd['pad_fraction']:.4f}, "
        f"{ms['packed']:.3f} ms a packed dispatch (embeds included) against {ms['by_resolution']:.3f} ms by "
        f"resolution; K1 0 in packed and embed graphs, 12 in each parity forward, on {smi}")
    del eng, model, f32

    # ---- 5. through the CLI: --serve --replicas 2, then --pack with pushes
    base = ["--config", str(HERE / FT_RECIPE), "--ckpt", str(ft), "--images", *files, "--max-batch", "64",
            "--task", "logits", "--serve", "--replicas", "2", "--warmup"]
    r = cli_predict_pool(fa, [*base, "--out", str(tmp / "serve" / "pool.npz")])
    engines = r["engines"]
    check(f"pool served {SERVE_IMAGES}/{SERVE_IMAGES} ok (0 failed)" in r["stdout"] and len(engines) == 2,
          f"replicated: --replicas 2: {r['stdout'][-800:]}")
    check(r["k1"] == 12 * sum(ran(e) for e in engines),
          f"replicated: --replicas 2 made {r['k1']} K1, want 12 x {sum(ran(e) for e in engines)}")
    direct = np.load(tmp / "serve" / "b16_logits.npz")["logits"]
    rel = float(np.linalg.norm(r["out"]["logits"] - direct) / np.linalg.norm(direct))
    check(rel <= 1e-2, f"replicated: the pool's logits against phase 19's direct path: {rel:.3e}")
    res["pool"] = {"k1": r["k1"], "wall_s": r["wall_s"], "rel_err": rel,
                   "dispatches": [e.dispatches for e in engines]}
    log(f"replicated: cli.predict --serve --replicas 2 --warmup served {SERVE_IMAGES} files in {r['wall_s']:.2f} s "
        f"(engines built and warmed included), {r['k1']} K1, dispatches {res['pool']['dispatches']}, against "
        f"the direct path relative error {rel:.3e}")

    watch = tmp / "push"
    watch.mkdir()
    staged = tmp / "staged"
    last = ft / "last"
    last_step = last / sorted((p.name for p in last.iterdir() if p.name.isdigit()), key=int)[-1]
    shutil.copytree(last_step, staged / "a_last")
    corrupt_copy(last_step, staged / "b_corrupt")

    def push(read):
        # what the watched directory holds when the watcher starts is its
        # baseline: push as traffic starts (after the parity gate); the
        # watcher takes both in one sweep, in name order
        wait_for(read, "pack parity: pass=True")
        (staged / "a_last").rename(watch / "a_last")
        (staged / "b_corrupt").rename(watch / "b_corrupt")

    r = cli_predict_pool(fa, [*base, "--pack", "--pack-resolutions", PACK_MIX, "--pack-parity-n", "16",
                              "--max-delay-ms", "100", "--interarrival-ms", "60", "--swap-watch", str(watch),
                              "--swap-poll-s", "0.1", "--swap-canary-requests", "4", "--swap-canary-timeout-s", "10",
                              "--out", str(tmp / "serve" / "packed.npz")], beside=push)
    out = r["stdout"]
    lines = [x for x in out.splitlines() if "swap " in x or "pack " in x or "pool served" in x]
    check(f"pool served {SERVE_IMAGES}/{SERVE_IMAGES} ok (0 failed)" in out and "pack parity: pass=True" in out,
          f"replicated: --pack: {out[-1500:]}")
    check("swap a_last: verdict=promoted stage=promote" in out, f"replicated: the push was not promoted: {lines}")
    check("swap b_corrupt: verdict=rolled_back stage=parity" in out, f"replicated: the corrupt push: {lines}")
    packed_k1 = {k: v["launches"] for e in r["engines"] for k, v in e.graph_stats().items() if ".packed:" in k}
    check(packed_k1 and not any(packed_k1.values()), f"replicated: packed graphs' launches {packed_k1}")
    check(r["out"]["logits"].shape == (SERVE_IMAGES, 1000) and bool(np.isfinite(r["out"]["logits"]).all()),
          "replicated: the packed logits")
    res["pack_cli"] = {"k1": r["k1"], "wall_s": r["wall_s"], "lines": lines,
                       "graphs": sorted({k for e in r["engines"] for k in e.graph_stats()})}
    log(f"replicated: cli.predict --replicas 2 --pack {PACK_MIX} with two pushes: " + "; ".join(lines)
        + f"; {r['k1']} K1 in {r['wall_s']:.2f} s; graphs {res['pack_cli']['graphs']}")
    res["seconds"] = time.perf_counter() - t_start
    res["k1"] = res["pool"]["k1"] + r["k1"]
    log(f"replicated: phase 20 in {res['seconds']:.1f} s")
    return res


# ------------------------------------------------------------ warm restarts


def spawn(argv: list[str], env: dict | None = None) -> tuple[subprocess.Popen, float]:
    """``python -m argv`` started in a process of its own from this
    checkout, and its start time."""
    proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, **(env or {})})
    LIVE_CHILDREN.add(proc)
    return proc, time.perf_counter()


def spawn_code(code: str, argv: list[str]) -> tuple[subprocess.Popen, float]:
    """``python -c code argv...`` started in a process of its own from this
    checkout, and its start time."""
    proc = subprocess.Popen([sys.executable, "-c", code, *argv], cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=dict(os.environ))
    LIVE_CHILDREN.add(proc)
    return proc, time.perf_counter()


def reap(started: tuple[subprocess.Popen, float], timeout_s: float = 300.0) -> tuple[dict, float]:
    """A :func:`spawn`ed child's last stdout line as JSON and its wall
    seconds. A non-zero exit fails the phase, with the end of its stderr."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        LIVE_CHILDREN.discard(proc)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not out.strip():
        log(f"child {proc.args[2]} exited {proc.returncode}; its stderr ends:\n{err[-3000:]}")
        check(False, f"child {' '.join(proc.args[2:4])} exited {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1]), wall


def child_json(argv: list[str], *, env: dict | None = None, timeout_s: float = 300.0) -> tuple[dict, float]:
    """``python -m argv`` in a process of its own, to its end: its last
    stdout line as JSON and its wall seconds."""
    return reap(spawn(argv, env), timeout_s)


# the warm-restart probes: (recipe, the save under the phase's tmp, tasks,
# quant, K1 a forward)
WARM_PROBES = {
    "b16": (FT_RECIPE, "ft/finetune_vit_b16/ckpt", ("features", "logits"), None, 12),
    "b16_int8": (FT_RECIPE, "ft/finetune_vit_b16/ckpt", ("features", "logits"), "int8", 12),
    "l16_recon": (RECIPE, "a/pretrain_vit_l16_in1k_800ep/ckpt", ("reconstruct",), None, 32),
}


def _split_text(rep: dict) -> str:
    parts = [f"{task}: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
             for task, split in rep["build"].items()]
    return (f"restore {rep['restore_s']:.4f}; " + "; ".join(parts) + f"; first runs {rep['first_run_s']:.4f}, "
            f"captures {rep['capture_s']:.4f} ({rep['captures']}); build+warmup {rep['init_s'] + rep['warmup_s']:.4f} s")


def phase_warm_restart(smi: str, tmp: Path) -> dict:
    """Phase 21: warm restarts, each run in a process of its own through
    ``python -m jumbo_mae_tpu_tpu_torch.infer.warmcache`` (the probe:
    build, warm the bucket ladder 1-64, serve 8 images, report), on the
    ViT-B/16 ``best`` of phase 16 (features and logits) and phase 13's
    ViT-L/16 save (the reconstruction). A bf16 build only copies the
    save's tensors and keeps no entry, so its one run is the cold start
    split into its parts, with the cache on and untouched. The int8
    build quantizes and keeps its entries: a cold run against an empty
    directory, a warm run against the same directory, and a third run
    after one entry is corrupted. Gates: the bf16 runs read and write
    nothing in the cache; the warm int8 run loads every task
    (``warm_hits``), misses nothing, captures as many graphs as the cold
    run and serves bit-equal outputs; the corrupted entry lands in
    ``quarantine/``, counts as a miss, and the run still serves bit-equal
    outputs; K1 = 12 x (dispatches + captures) at ViT-B/16 and 32 x at
    ViT-L/16. The two bf16 runs (each on a directory of its own) run one
    after the other beside the int8 runs' sequence."""
    import numpy as np

    t_start = time.perf_counter()
    res: dict = {"k1": 0, "runs": {}}
    counted = threading.Lock()  # the bf16 runs report from a thread of their own

    def probe(name: str, run: str) -> dict:
        recipe, ckpt, tasks, quant, k1_fwd = WARM_PROBES[name]
        d = tmp / "warm" / name
        out = d.parent / f"{name}_{run}.npz"
        argv = ["jumbo_mae_tpu_tpu_torch.infer.warmcache", "--dir", str(d), "--recipe", str(HERE / recipe),
                "--ckpt", str(tmp / ckpt), "--task", *tasks, "--max-batch", "64", "--probe-images", "8",
                "--save-outputs", str(out)] + (["--quant", quant] if quant else [])
        rep, wall = child_json(argv)
        rep["wall_s"] = wall
        rep["outputs"] = dict(np.load(out))
        k1 = rep["launches"]["K1"]
        check(k1 == k1_fwd * (rep["dispatches"] + rep["captures"]),
              f"warm {name} {run}: {k1} K1 in {rep['dispatches']} dispatches and {rep['captures']} captures")
        check(rep["hot_path_captures"] == 0, f"warm {name} {run}: the request path captured")
        log(f"warm {name} {run}: {_split_text(rep)}; process {wall:.2f} s; {rep['warmcache']}")
        with counted:
            res["k1"] += k1
            res["runs"][f"{name}/{run}"] = {k: rep[k] for k in ("init_s", "warmup_s", "restore_s", "build",
                                                                 "first_run_s", "capture_s", "captures", "dispatches",
                                                                 "warm_hits", "wall_s")}
            res["runs"][f"{name}/{run}"]["warmcache"] = {k: v for k, v in rep["warmcache"].items() if k != "root"}
        return rep

    def same(a: dict, b: dict) -> bool:
        return a.keys() == b.keys() and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)

    def puts_s(rep: dict) -> float:
        return sum(split.get("put_s", 0.0) for split in rep["build"].values())

    def save_only() -> dict:
        out = {}
        for name in ("b16", "l16_recon"):
            cold = probe(name, "cold")
            wc = cold["warmcache"]
            check(cold["warm_hits"] == 0 and (wc["hits"], wc["misses"], wc["puts"], wc["entries"]) == (0, 0, 0, 0),
                  f"warm {name}: a save-only build used the cache {wc}")
            out[name] = {"cold_s": cold["init_s"] + cold["warmup_s"], "cold_wall_s": cold["wall_s"]}
        return out

    def int8() -> None:
        """The int8 runs, one after the other: cold against an empty
        directory, warm against the same directory, then after one entry
        is corrupted."""
        name = "b16_int8"
        tasks = WARM_PROBES[name][2]
        cold = probe(name, "cold")
        wc = cold["warmcache"]
        check(cold["warm_hits"] == 0 and wc["misses"] == len(tasks) and wc["puts"] == len(tasks),
              f"warm {name}: the cold run's cache {wc}")
        warm = probe(name, "warm")
        wc = warm["warmcache"]
        check(warm["warm_hits"] == len(tasks) and wc["misses"] == 0 and wc["quarantined"] == 0,
              f"warm {name}: the warm run's cache {wc}")
        check(warm["captures"] == cold["captures"],
              f"warm {name}: {warm['captures']} captures, cold {cold['captures']}")
        check(same(cold["outputs"], warm["outputs"]), f"warm {name}: the warm outputs differ from the cold")
        cold_s, warm_s = cold["init_s"] + cold["warmup_s"], warm["init_s"] + warm["warmup_s"]
        log(f"warm {name}: build + warmup {warm_s:.3f} s warm against {cold_s:.3f} s cold "
            f"({cold_s - puts_s(cold):.3f} s less its puts); process {warm['wall_s']:.2f} s against "
            f"{cold['wall_s']:.2f} s, on {smi}")
        res[name] = {"cold_s": cold_s, "cold_less_puts_s": cold_s - puts_s(cold), "warm_s": warm_s,
                     "cold_wall_s": cold["wall_s"], "warm_wall_s": warm["wall_s"]}
        d = tmp / "warm" / name
        entry = next(p for p in sorted(d.glob("*.exe")) if "-features-" in p.name)
        blob = bytearray(entry.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        entry.write_bytes(bytes(blob))
        bad = probe(name, "corrupt")
        wc = bad["warmcache"]
        quarantined = sorted(p.name for p in (d / "quarantine").iterdir())
        check(wc["quarantined"] == 1 and wc["misses"] == 1 and bad["warm_hits"] == len(tasks) - 1
              and len(quarantined) == 1 and quarantined[0].startswith(entry.name),
              f"warm {name}: the corrupted entry's run {wc}, quarantine {quarantined}")
        check(same(cold["outputs"], bad["outputs"]), f"warm {name}: outputs after the corrupted entry differ")

    bf16_runs = Background(save_only)  # beside the int8 runs
    int8()
    res.update(bf16_runs.join())
    res["seconds"] = time.perf_counter() - t_start
    log(f"warm: phase 21 in {res['seconds']:.1f} s, {res['k1']} K1 launches in its runs")
    return res


# -------------------------------------------------------------- batch jobs


def batch_compare(a: Path, b: Path) -> dict:
    """Two job directories of the same shards: their manifests and parts
    byte-equal, or else the same shards, parts, keys and counts with each
    record's relative error and cosine against ``a``'s."""
    import numpy as np

    from jumbo_mae_tpu_tpu_torch.batch import iter_records, read_manifest

    ma, mb = read_manifest(a / "manifest.json"), read_manifest(b / "manifest.json")
    check(ma is not None and mb is not None, f"batch: no manifest in {a} or {b}")
    out = {"manifest_equal": (a / "manifest.json").read_bytes() == (b / "manifest.json").read_bytes(),
           "rel_err_max": 0.0, "cosine_min": 1.0}
    check([(s["shard"], s["part"], s["samples"]) for s in ma["shards"]]
          == [(s["shard"], s["part"], s["samples"]) for s in mb["shards"]]
          and ma["total_samples"] == mb["total_samples"], f"batch: {b}'s shards, parts or counts differ from {a}'s")
    for s in ma["shards"]:
        ra, rb = list(iter_records(a / "parts" / s["part"])), list(iter_records(b / "parts" / s["part"]))
        check([r["key"] for r in ra] == [r["key"] for r in rb], f"batch: the keys of {s['part']} differ")
        for x, y in zip(ra, rb):
            x, y = np.asarray(x["out"], np.float64), np.asarray(y["out"], np.float64)
            out["rel_err_max"] = max(out["rel_err_max"], float(np.linalg.norm(x - y) / np.linalg.norm(x)))
            out["cosine_min"] = min(out["cosine_min"], float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y))))
    return out


def phase_batch_job(smi: str, tmp: Path, urls: dict) -> dict:
    """Phase 22: ``python -m jumbo_mae_tpu_tpu_torch.cli.batch`` over the
    first 2 train shards of phase 13 (512 images at 224 px), ViT-B/16
    features from phase 16's ``best`` through 2 replicas on this card,
    buckets up to 64, each run a process of its own: straight through
    with 2 job workers; SIGKILLed once its first part is durable, then run
    again to completion (1 worker, so that a part is durable while the
    second shard runs); and with the ``batch.worker`` fault site killing
    worker w0 of 2 on its first sample (completed by a lease steal).
    First it serves one image at every bucket of the ladder and reports
    whether its features are bit-equal at all of them. Bit-equal: the
    killed and faulted runs' manifests must be byte-identical to the
    straight run's. Else those runs are held to the same shards, keys and
    counts with every record within relative error 1e-2 and cosine >=
    0.999 of the straight run's, and the byte-identical gate runs on a
    one-bucket ladder (buckets of 1, 1 worker), straight and SIGKILLed.
    The straight run and the SIGKILLed ones run side by side (in
    chip_smoke.py phase 29's (b) and (c) share the card with the whole
    phase). K1 = 12
    x (dispatches + captures) in every run; ``python -m
    jumbo_mae_tpu_tpu_torch.tools.batch_doctor`` exits 0 after each."""
    import signal

    import numpy as np

    from jumbo_mae_tpu_tpu_torch.cli.batch import image_decoder
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.data.shards import expand_shards
    from jumbo_mae_tpu_tpu_torch.data.tario import iter_tar_samples
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
    from jumbo_mae_tpu_tpu_torch.infer.bucketing import pow2_rungs

    t_start = time.perf_counter()
    shards = expand_shards(urls["train"])
    check(len(shards) == 4, f"batch: phase 13 wrote {len(shards)} train shards, want 4")
    ft = tmp / "ft" / "finetune_vit_b16" / "ckpt"
    root = tmp / "batch"
    res: dict = {"k1": 0, "runs": {}}

    # ---- 0. one image at every bucket of the ladder
    cfg = load_config(HERE / FT_RECIPE)
    decode = image_decoder(224, cfg.data.test_crop_ratio)
    images = np.stack([decode(s) for s, _ in zip(iter_tar_samples(shards[0]), range(64))])
    eng = InferenceEngine(cfg, ckpt=str(ft), max_batch=64, warm_cache=False)
    rows = {b: eng.dispatch("features", images[:b], pool="cls")[0] for b in pow2_rungs(64)}
    invariant = all(np.array_equal(rows[1], r) for r in rows.values())
    spread = {b: float(np.abs(r - rows[1]).max()) for b, r in rows.items()}
    res["bucket_invariant"] = invariant
    res["bucket_max_abs_diff"] = spread
    log(f"batch: one image's features at buckets {list(rows)} bit-equal at every bucket: {invariant}; max |diff| "
        f"against bucket 1 {json.dumps(spread)}, on {smi}")
    del eng

    def cmd(out: Path, max_batch: int, *extra: str, workers: int = 1) -> list[str]:
        """The job at ``max_batch`` over the first 2 shards: with 1 worker
        (the kills and the one-bucket ladder) a part is durable while the
        second shard runs."""
        return ["jumbo_mae_tpu_tpu_torch.cli.batch", *shards[:2], "--out", str(out), "--config",
                str(HERE / FT_RECIPE), "--ckpt", str(ft), "--task", "features", "--replicas", "2", "--workers",
                str(workers), "--max-batch", str(max_batch), "--submit-window", "32", *extra]

    def doctor(out: Path) -> None:
        r = subprocess.run([sys.executable, "-m", "jumbo_mae_tpu_tpu_torch.tools.batch_doctor", str(out), "--out",
                            str(out / "doctor.md")], cwd=HERE, capture_output=True, text=True, timeout=120)
        check(r.returncode == 0, f"batch: batch_doctor exited {r.returncode} on {out}: {r.stderr[-2000:]}")

    counted = threading.Lock()  # two kill flows finish on threads of their own

    def finished(name: str, summary: dict, wall: float, out: Path, want: int = 512) -> dict:
        e = summary["engines"]
        with counted:
            res["k1"] += e["k1_launches"]
        check(summary["complete"] and summary["total_samples"] == want and not summary["errors"],
              f"batch {name}: complete {summary['complete']}, {summary['total_samples']} samples, {summary['errors']}")
        check(e["k1_launches"] == 12 * (e["dispatches"] + e["captures"]),
              f"batch {name}: {e['k1_launches']} K1 in {e['dispatches']} dispatches and {e['captures']} captures")
        doctor(out)
        rate = summary["samples_processed"] / summary["seconds"]
        occ = summary["scheduler"]["batch_occupancy"]
        log(f"batch {name}: {summary['samples_processed']} images computed ({summary['samples_resumed']} resumed) in "
            f"{summary['seconds']:.3f} s, {rate:.1f} images/s; scheduler occupancy {occ:.3f} over "
            f"{summary['scheduler']['batches']} groups, pool occupancy {summary['pool']['batch_occupancy']:.3f}; "
            f"{e['k1_launches']} K1 in {e['dispatches']} dispatches + {e['captures']} captures; lease steals "
            f"{summary['lease_steals']}; process {wall:.2f} s, on {smi}")
        res["runs"][name] = {"images_per_s": rate, "seconds": summary["seconds"], "wall_s": wall,
                             "processed": summary["samples_processed"], "resumed": summary["samples_resumed"],
                             "occupancy": occ, "k1": e["k1_launches"], "dispatches": e["dispatches"],
                             "captures": e["captures"], "lease_steals": summary["lease_steals"]}
        return summary

    def killed(name: str, out: Path, max_batch: int) -> None:
        """The job SIGKILLed once its first part is durable, then run again
        to completion."""
        proc = subprocess.Popen([sys.executable, "-m", *cmd(out, max_batch)], cwd=HERE, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            deadline = time.monotonic() + 240
            while not list((out / "parts").glob("*.part")):
                check(proc.poll() is None and time.monotonic() < deadline, f"batch {name}: no part before the kill")
                time.sleep(0.01)
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
        parts = sorted(p.name for p in (out / "parts").iterdir())
        check(not (out / "manifest.json").exists(), f"batch {name}: the job completed before the kill")
        log(f"batch {name}: SIGKILLed with {parts} on disk")
        summary, wall = child_json(cmd(out, max_batch))
        finished(name, summary, wall, out)
        check(summary["samples_resumed"] > 0, f"batch {name}: the restart resumed nothing")

    # ---- 1. straight through, beside 2. SIGKILL and restart and the
    # one-bucket ladder's SIGKILL where the buckets disagree (each job a
    # process of its own on a directory of its own; the rates are those of
    # jobs sharing the card); then 3. a worker killed, beside the one-bucket
    # ladder's straight run
    straight = root / "straight"

    def straight_run() -> None:
        summary, wall = child_json(cmd(straight, 64, workers=2))
        finished("straight", summary, wall, straight)

    with ThreadPoolExecutor(max_workers=3) as px:
        runs = [px.submit(straight_run), px.submit(killed, "sigkill", root / "sigkill", 64)]
        if not invariant:
            runs.append(px.submit(killed, "one_bucket_sigkill", root / "one_bucket_sigkill", 1))
        for f in runs:
            f.result()
    fault, one = root / "fault", root / "one_bucket"
    faulted = spawn(cmd(fault, 64, "--lease-s", "3", workers=2),
                    env={"GRAFT_FAULTS": "batch.worker:raise@key~w0,n<1"})
    one_run = None if invariant else spawn(cmd(one, 1))
    try:
        summary, wall = reap(faulted)
        finished("fault", summary, wall, fault)
        check(summary["lease_steals"] >= 1, f"batch fault: {summary['lease_steals']} lease steals")
    except BaseException:
        if one_run is not None:  # no child outlives a failed gate
            one_run[0].kill()
            one_run[0].wait()
        raise
    for name in ("sigkill", "fault"):
        cmp = batch_compare(straight, root / name)
        res["runs"][name]["against_straight"] = cmp
        log(f"batch {name} against straight: {json.dumps(cmp)}")
        if invariant:
            check(cmp["manifest_equal"], f"batch {name}: the manifest differs from the straight run's")
        else:
            check(cmp["rel_err_max"] <= 1e-2 and cmp["cosine_min"] >= 0.999,
                  f"batch {name}: records against the straight run's {cmp}")
    if one_run is not None:
        # the byte-identical gate on a one-bucket ladder
        summary, wall = reap(one_run)
        finished("one_bucket", summary, wall, one)
        cmp = batch_compare(one, root / "one_bucket_sigkill")
        res["runs"]["one_bucket_sigkill"]["against_one_bucket"] = cmp
        log(f"batch one_bucket_sigkill against one_bucket: {json.dumps(cmp)}")
        check(cmp["manifest_equal"] and cmp["rel_err_max"] == 0.0,
              "batch: on the one-bucket ladder the SIGKILLed job's manifest differs")
    res["seconds"] = time.perf_counter() - t_start
    log(f"batch: phase 22 in {res['seconds']:.1f} s, {res['k1']} K1 launches in its completed runs")
    shutil.rmtree(root, ignore_errors=True)
    return res


# ------------------------------------------------------------ billing


# the child of phase 23(a): cli.predict in a process of its own, the
# engines and the meter it builds recorded, K1 counted over the run
BILLING_CHILD = r"""
import contextlib, io, json, sys
from jumbo_mae_tpu_tpu_torch import serve
from jumbo_mae_tpu_tpu_torch.cli import predict
from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry
from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa
made = {"engines": [], "meters": []}
class Engine(predict.InferenceEngine):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        made["engines"].append(self)
class Meter(serve.CostMeter):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        made["meters"].append(self)
predict.InferenceEngine, serve.CostMeter = Engine, Meter
buf = io.StringIO()
fa.LAUNCHES = 0
with contextlib.redirect_stdout(buf):
    predict.main(sys.argv[1:])
k1 = fa.LAUNCHES
(meter,) = made["meters"]
left = get_registry().gauge("serve_tenant_budget_remaining", labels=("tenant", "class")).children()
print(json.dumps({"k1": k1, "stdout": buf.getvalue(), "snapshot": meter.snapshot(),
                  "ran": [e.dispatches + sum(e.compile_counts.values()) for e in made["engines"]],
                  "costs": {f"{k[0]}/b{k[1]}": c.flops for e in made["engines"][:1] for k, c in e.cost_reports.items()},
                  "budget_remaining": {",".join(k): c.value for k, c in left.items()}}))
"""


def meter_overhead_us(rows: int, reps: int = 400) -> float:
    """Host µs of one ``CostMeter.observe_batch`` of ``rows`` traces (two
    tenants, a cost table), the median of ``reps`` calls."""
    from types import SimpleNamespace

    import numpy as np

    from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry
    from jumbo_mae_tpu_tpu_torch.serve import CostMeter, parse_tenants

    meter = CostMeter(parse_tenants("web=interactive,scrape=batch:budget=5"),
                      cost_fn=lambda e, t, b: {"flops": 1e9 * b}, registry=MetricsRegistry())
    traces = [SimpleNamespace(tenant=("web", "scrape")[i % 2], tclass=("interactive", "batch")[i % 2], task="logits",
                              bucket=64, pad_fraction=0.0, tokens=None, device_s=None, cost_flops=None)
              for i in range(rows)]
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        meter.observe_batch(run_s=0.012, traces=traces, batch=rows)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def phase_billing(fa, smi: str, tmp: Path, urls: dict, train_step_ms: float) -> dict:
    """Phase 23: tenant cost metering with device-second budgets, the
    autoscaler on the H100 roofline, and the gated train→serve weights
    publisher (the module docstring's list). Each path sets the launch
    counts to 0 just before it and reads them just after."""
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.data.shards import expand_shards
    from jumbo_mae_tpu_tpu_torch.faults import clear_plan, install_plan
    from jumbo_mae_tpu_tpu_torch.interop.from_jax import flax_tree_from_state_dict
    from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, preset
    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
    from jumbo_mae_tpu_tpu_torch.obs.mfu import classify_flops_per_image, encoder_flops_per_image
    from jumbo_mae_tpu_tpu_torch.obs.perfmodel import detect_chip, predict_train_step, publish_drift
    from jumbo_mae_tpu_tpu_torch.serve import publisher as pub
    from jumbo_mae_tpu_tpu_torch.serve import roofline_capacity
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import read_state

    t_start = time.perf_counter()
    chip = detect_chip("cuda")
    res: dict = {"chip": {"name": chip.name, "hbm_bytes": chip.hbm_bytes}}
    ft = tmp / "ft" / "finetune_vit_b16" / "ckpt"
    files = sorted(str(p) for p in (tmp / "serve" / "images").glob("*.png"))
    check(len(files) == SERVE_IMAGES, f"billing: phase 19's {len(files)} files")
    cfg = load_config(HERE / FT_RECIPE)
    enc = preset(cfg.model.preset, **{**cfg.model.overrides, "mask_ratio": None, "labels": 1000})
    per_image = classify_flops_per_image(enc, training=False)  # the logits forward: encoder and head

    # ---- (a) tenants and the autoscaler, in a process of its own
    acc = tmp / "billing" / "access"
    burst, tail = 6 * SERVE_IMAGES, 3 * SERVE_IMAGES
    argv = ["--config", str(HERE / FT_RECIPE), "--ckpt", str(ft), "--images", *(files * 9), "--task", "logits",
            "--max-batch", "64", "--serve", "--replicas", "1", "--warmup", "--tenants",
            "web=interactive:rate=100000,scrape=batch:budget=0.005:window=2", "--autoscale", "1:2",
            "--autoscale-interval-s", "0.02", "--access-log", str(acc), "--burst", str(burst),
            "--interarrival-ms", "40", "--out", str(tmp / "billing" / "served.npz")]
    child, wall = reap(spawn_code(BILLING_CHILD, argv), timeout_s=300)
    out = child["stdout"]
    n = burst + tail
    check(f"pool served {n}/{n} ok (0 failed)" in out and "request shed" not in out,
          f"billing: requests failed or shed: {out[-1500:]}")
    events = read_journal(acc)
    scaled = [e for e in events if e["type"] == "autoscale"]
    moves = [(e["direction"], e["scaled_from"], e["scaled_to"]) for e in scaled]
    check(moves == [("up", 1, 2), ("down", 2, 1)], f"billing: autoscale events {moves}")
    rows = [e for e in events if e["type"] == "request"]
    ok = [r for r in rows if r["outcome"] == "ok"]
    check(len(rows) == len(ok) == n, f"billing: {len(ok)} ok rows of {len(rows)}: no request shed, none failed")
    snap = child["snapshot"]
    tenants = snap["tenants"]
    dev = sum(t["device_s"] for t in tenants.values())
    flops = sum(t["flops"] for t in tenants.values())
    check(abs(dev - snap["total_device_s"]) <= 1e-9 * snap["total_device_s"]
          and abs(flops - snap["total_flops"]) <= 1e-9 * snap["total_flops"],
          f"billing: conservation: tenants {dev} s / {flops} FLOPs against {snap['total_device_s']} / "
          f"{snap['total_flops']}")
    costs = child["costs"]
    check(all(c == per_image * int(k.rsplit("/b", 1)[1]) for k, c in costs.items() if k.startswith("logits/")),
          f"billing: graph costs {costs} against {per_image} FLOPs an image")
    for tenant in ("web", "scrape"):
        want = sum(per_image * r["bucket"] / r["batch"] for r in ok if r["tenant"] == tenant)
        got = tenants[tenant]["flops"]
        check(abs(got - want) <= 1e-9 * want and tenants[tenant]["requests"] == n // 2,
              f"billing: {tenant} billed {got} FLOPs for {tenants[tenant]['requests']} rows, analytic {want}")
    left = child["budget_remaining"].get("scrape,batch")
    check(left == 0.0, f"billing: scrape's budget left {left}")
    check(child["k1"] == 12 * sum(child["ran"]) and len(child["ran"]) == 2,
          f"billing: {child['k1']} K1 over engines that ran {child['ran']} forwards")
    capacity = roofline_capacity(encoder_flops_per_image(enc, masked=False),
                                 2.0 * encoder_flops_per_image(enc, masked=False) / enc.dim, chip)
    # the burst's requests (the first `burst` trace ids): served on the
    # host clock from the first submit to the last result, and per metered
    # second of their own batches' runs
    burst_rows = [r for r in ok if r["rid"] < burst]
    start = min(r["ts"] - r["lat_ms"] / 1e3 for r in burst_rows)
    host_rate = len(burst_rows) / max(max(r["ts"] for r in burst_rows) - start, 1e-9)
    device_rate = len(burst_rows) / (sum(r["device_ms"] for r in burst_rows) / 1e3)
    res["serve"] = {"k1": child["k1"], "ran": child["ran"], "wall_s": wall, "moves": moves,
                    "decisions": [{k: e[k] for k in ("demand_rps", "capacity_rps", "queue_depth", "current", "target")}
                                  for e in scaled],
                    "tenants": {t: {k: v[k] for k in ("requests", "device_s", "flops", "waste_device_s")}
                                for t, v in tenants.items()},
                    "total_device_s": snap["total_device_s"], "batches": snap["total_batches"],
                    "roofline_utilization": snap.get("roofline_utilization"),
                    "roofline_capacity_rps": capacity, "burst_rps": host_rate, "device_rps": device_rate,
                    "ratio": capacity / device_rate}
    log(f"billing (a): {n} requests ({burst} in a burst, {tail} at 40 ms) served, none shed or failed; autoscale "
        f"{moves}; K1 {child['k1']} = 12 x {child['ran']} forwards; meter {snap['total_batches']} batches, "
        f"{snap['total_device_s']:.4f} device-s, tenants "
        + ", ".join(f"{t} {v['device_s']:.4f} s / {v['flops'] / 1e12:.3f} TFLOP" for t, v in tenants.items())
        + f", conservation exact to 1e-9; scrape's budget gauge 0; roofline capacity {capacity:.1f} images/s a "
        f"replica (H100 row, utilization 0.5) against the burst's {device_rate:.1f} images per metered second of "
        f"its batches' runs (ratio {capacity / device_rate:.3f}) and {host_rate:.1f} images/s from its first submit "
        f"to its last result, on {smi}")

    # ---- (b) the publisher: a finetune with run.publish_dir, then the swap watch
    staged = tmp / "billing" / "staged"
    mae16 = tmp / "b16" / "pretrain_vit_b16_in1k_1600ep" / "ckpt"
    sets = [*CLASSIFY_SETS, "run.epochs=1.0", "run.ckpt_every=2", "optim.learning_rate=2e-6", "optim.layer_decay=0.05",
            "run.sanity_eval=false", f"data.train_shards={urls['train']}", f"data.valid_shards={urls['val']}",
            f"run.output_dir={tmp / 'billing' / 'ft'}", f"run.pretrained_ckpt={mae16}", f"run.publish_dir={staged}"]
    rec = run_driver(fa, ["--config", str(HERE / FT_RECIPE), "--set", *sets])
    c, steps = rec["counts"], len(rec["metrics"])
    train_k1 = c["K1"] - rec["eval_k1"]
    check(steps == 4 and train_k1 == 12 * steps and c["K2"] == c["K3"] == 12 * steps,
          f"billing: the publisher's finetune: {steps} steps, K1 {train_k1} (+{rec['eval_k1']} eval), K2 {c['K2']}, "
          f"K3 {c['K3']}")
    full, delta = (pub.load_manifest(staged / f"publish-00000{i}") for i in range(2))
    for m in (full, delta):
        pub.verify_artifact(staged / m["name"])
    check(full["base"] is None and full["step"] == 2 and delta["step"] == 4 and delta["quant"] == "int8"
          and delta["base"] == {"name": full["name"], "fingerprint": full["fingerprint"]},
          f"billing: the chain {full['base']} -> {delta['base']}")
    # the step-4 tree exported whole: the delta resolves to its fingerprint
    run_dir = tmp / "billing" / "ft" / "finetune_vit_b16"
    sd = read_state(run_dir / "ckpt", step=4)["model"]
    params, stats = flax_tree_from_state_dict(sd, heads=enc.heads)
    whole = pub.CheckpointPublisher(tmp / "billing" / "whole", full_every=1).publish(4, params, batch_stats=stats)
    _, _, head = pub.resolve_chain(staged / delta["name"])
    check(pub.load_manifest(whole)["fingerprint"] == head["fingerprint"] == delta["fingerprint"],
          "billing: the delta does not resolve to the full export's fingerprint")
    install_plan("publish.export:corrupt(6)")
    try:
        corrupt = pub.CheckpointPublisher(staged, full_every=1).publish(5, params, batch_stats=stats)
    finally:
        clear_plan()
    journal = read_journal(run_dir / "journal")
    published = [e for e in journal if e["type"] == "publish"]
    billed = [e for e in journal if e["type"] == "tenant_usage" and e["tenant"] == "publish"]
    check(len(published) == 2 and billed and billed[-1]["requests"] == 2, f"billing: publish journal {published}")
    res["publish"] = {
        "k1": c["K1"], "k2": c["K2"], "k3": c["K3"], "steps": steps, "wall_s": rec["wall_s"],
        "artifacts": [{k: e[k] for k in ("name", "step", "bytes", "seconds", "delta_fraction", "leaves",
                                         "delta_leaves")} for e in published],
        "publish_device_s": billed[-1]["device_s"]}
    log(f"billing (b): finetune 4 steps with run.publish_dir: K1 {train_k1} (+{rec['eval_k1']} eval) K2 {c['K2']} "
        f"K3 {c['K3']}; artifacts " + "; ".join(
            f"{a['name']} step {a['step']}: {a['delta_leaves']}/{a['leaves']} leaves, {a['bytes']} bytes in "
            f"{a['seconds']} s" for a in res["publish"]["artifacts"])
        + f"; the delta resolves to the full export's fingerprint; the corrupt export {corrupt.name} written, on {smi}")
    watch = tmp / "billing" / "push"
    watch.mkdir()

    def push(read):
        # all three in one sweep, in name order: the delta's base lands
        # beside it, and the swaps run while the traffic lasts
        wait_for(read, "swap-watch: polling")
        for name in (full["name"], delta["name"], corrupt.name):
            (staged / name).rename(watch / name)

    base = ["--config", str(HERE / FT_RECIPE), "--ckpt", str(run_dir / "ckpt" / "last" / "2"), "--images",
            *(files * 4), "--max-batch", "64", "--task", "logits", "--serve", "--replicas", "2",
            "--interarrival-ms", "40", "--swap-watch", str(watch), "--swap-poll-s", "0.1", "--swap-canary-requests",
            "4", "--swap-canary-timeout-s", "10", "--out", str(tmp / "billing" / "swapped.npz")]
    r = cli_predict_pool(fa, base, beside=push)
    out = r["stdout"]
    lines = [x for x in out.splitlines() if "swap publish-" in x or "pool served" in x]
    check(f"swap {full['name']}: verdict=promoted stage=promote" in out
          and f"swap {delta['name']}: verdict=promoted stage=promote" in out, f"billing: promotions {lines}")
    check(f"swap {corrupt.name}: verdict=quarantined stage=verify" in out
          and (watch / ".quarantine" / corrupt.name).is_dir(), f"billing: the corrupt artifact {lines}")
    check(f"pool served {4 * SERVE_IMAGES}/{4 * SERVE_IMAGES} ok (0 failed)" in out, f"billing: swap traffic {lines}")
    check(r["k1"] == 12 * sum(ran(e) for e in r["engines"]), f"billing: swap pool K1 {r['k1']}")
    doc = subprocess.run([sys.executable, "-m", "jumbo_mae_tpu_tpu_torch.tools.publish_doctor", str(watch)],
                         cwd=HERE, capture_output=True, text=True, timeout=120)
    check(doc.returncode == 0 and "OK: 2 artifact(s) verified" in doc.stdout, f"billing: publish_doctor {doc.stdout}")
    res["publish"]["swap_lines"] = lines
    log("billing (b): " + "; ".join(lines) + f"; publish_doctor: {doc.stdout.strip().splitlines()[-1]}")

    # ---- (c) a batch job with a budgeted tenant, over the first 2 shards
    job = tmp / "billing" / "job"
    shards = expand_shards(urls["train"])[:2]
    summary, wall = child_json(["jumbo_mae_tpu_tpu_torch.cli.batch", *shards, "--out", str(job),
                                "--config", str(HERE / FT_RECIPE), "--ckpt", str(ft), "--task", "features",
                                "--replicas", "1", "--workers", "2", "--max-batch", "64", "--submit-window", "32",
                                "--tenants", "batch=batch:budget=0.5:window=10"])
    usage = summary.get("tenant_usage", {}).get("batch")
    check(summary["complete"] and usage is not None and usage["requests"] == 512,
          f"billing: the batch job's tenant_usage {summary.get('tenant_usage')}")
    feats = encoder_flops_per_image(enc, masked=False)
    jrows = [e for e in read_journal(job / "access") if e["type"] == "request" and e["outcome"] == "ok"]
    want = sum(feats * r["bucket"] / r["batch"] for r in jrows)
    check(len(jrows) == 512 and abs(usage["flops"] - want) <= 1e-9 * want,
          f"billing: batch billed {usage['flops']} FLOPs, analytic {want}")
    e = summary["engines"]
    check(e["k1_launches"] == 12 * (e["dispatches"] + e["captures"]), f"billing: batch K1 {e}")
    doc = subprocess.run([sys.executable, "-m", "jumbo_mae_tpu_tpu_torch.tools.cost_doctor", str(job / "access")],
                         cwd=HERE, capture_output=True, text=True, timeout=120)
    check(doc.returncode == 0 and "device-seconds: rows" in doc.stdout and "— agree" in doc.stdout,
          f"billing: cost_doctor {doc.returncode} {doc.stdout[-1500:]}")
    res["batch"] = {"usage": usage, "k1": e["k1_launches"], "wall_s": wall, "seconds": summary["seconds"],
                    "reconcile": [x for x in doc.stdout.splitlines() if x.startswith("- device-seconds")]}
    log(f"billing (c): cli.batch over 512 images billed {usage['device_s']} device-s and "
        f"{usage['flops'] / 1e12:.3f} TFLOP to `batch` (over budget: {usage.get('over_budget')}); cost_doctor "
        f"{res['batch']['reconcile']}; K1 {e['k1_launches']}, on {smi}")

    # ---- the meter's own cost: host µs of one flush's observe_batch
    res["meter_us"] = {rows: meter_overhead_us(rows) for rows in (1, 8, 64)}
    log(f"billing: CostMeter.observe_batch host µs a flush by rows {res['meter_us']} (this machine's CPU)")

    # ---- (d) the drift line: the ViT-L/16 MAE step on the H100 row against phase 7
    l16 = load_config(HERE / RECIPE)
    m = l16.model
    pred = predict_train_step(preset(m.preset, **{"labels": None, "mask_ratio": 0.75, **m.overrides}),
                              DecoderConfig(layers=m.dec_layers, dim=m.dec_dim, heads=m.dec_heads),
                              per_device_batch=128, chip=chip)
    ratio = publish_drift(pred.step_time_s, train_step_ms / 1e3, program="mae_vit_l16_b128")
    check(pred.bound == "compute" and 0.0170 < pred.t_compute_s < 0.0182, f"billing: the predicted step {pred}")
    res["drift"] = {"predicted_ms": pred.step_time_s * 1e3, "compute_ms": pred.t_compute_s * 1e3,
                    "memory_ms": pred.t_memory_s * 1e3, "measured_ms": train_step_ms, "ratio": ratio}
    log(f"billing (d): predicted ViT-L/16 MAE step at batch 128 on the H100 row {pred.step_time_s * 1e3:.3f} ms "
        f"({pred.bound}-bound; memory term {pred.t_memory_s * 1e3:.3f} ms) against phase 7's {train_step_ms:.2f} ms: "
        f"measured / predicted {ratio:.3f}, on {smi}")
    res["seconds"] = time.perf_counter() - t_start
    log(f"billing: phase 23 in {res['seconds']:.1f} s")
    res["k1"] = child["k1"] + r["k1"] + e["k1_launches"]
    return res


# ------------------------------------------------------ telemetry and health


# the child of phase 24: cli.predict in a process of its own with its
# stdout unbuffered (the parent reads it as it comes), the engines it
# builds recorded, K1 counted over the run; after it, each engine's output
# for the files (argv[1], a JSON list) into argv[2] (.npz)
TELEMETRY_CHILD = r"""
import json, sys
import numpy as np
from jumbo_mae_tpu_tpu_torch.cli import predict
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa
made = []
class Engine(predict.InferenceEngine):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        made.append(self)
predict.InferenceEngine = Engine
files, npz, argv = json.loads(open(sys.argv[1]).read()), sys.argv[2], sys.argv[3:]
fa.LAUNCHES = 0
predict.main(argv)
k1 = fa.LAUNCHES
ran = [e.dispatches + sum(e.compile_counts.values()) for e in made]
peaks = sorted({k for e in made for k in e.predicted_peak_hbm()})
cfg = load_config(argv[argv.index("--config") + 1])
images = np.stack([predict.load_image(f, made[0].image_size, cfg.data.test_crop_ratio) for f in files])
task = argv[argv.index("--task") + 1]
np.savez(npz, **{f"e{i}": e.predict(images, task=task) for i, e in enumerate(made)})
print(json.dumps({"k1": k1, "ran": ran, "peaks": peaks, "gens": len(made)}))
"""


def hooks_host_us(reps: int = 20000) -> float:
    """Host µs of the metric calls one engine dispatch makes (a bucket
    cache hit, the pad fraction, the predict seconds, the images count),
    on a live registry: the median of 5 runs of ``reps``."""
    import numpy as np

    from jumbo_mae_tpu_tpu_torch.obs.metrics import RATIO_BUCKETS, MetricsRegistry

    reg = MetricsRegistry()
    hits = reg.counter("infer_bucket_cache_hits_total", labels=("task",))
    pad = reg.histogram("infer_pad_fraction", buckets=RATIO_BUCKETS)
    pred = reg.histogram("infer_predict_seconds", labels=("task",))
    imgs = reg.counter("infer_images_total", labels=("task",))
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            hits.labels("logits").inc()
            pad.observe(0.0)
            pred.labels("logits").observe(0.004)
            imgs.labels("logits").inc(64)
        runs.append((time.perf_counter() - t0) / reps * 1e6)
    return float(np.median(runs))


def scrape(url: str) -> tuple[int, str, float]:
    """One GET over loopback: its status, body and wall ms."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            status, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read().decode()
    return status, body, (time.perf_counter() - t0) * 1e3


def metric(text: str, name: str, labels: str = "") -> float | None:
    """A sample's value in Prometheus text (``labels`` as rendered)."""
    key = f"{name}{{{labels}}} " if labels else f"{name} "
    for line in text.splitlines():
        if line.startswith(key):
            return float(line[len(key):])
    return None


def phase_telemetry(fa, smi: str, tmp: Path) -> dict:
    """Phase 24: serving telemetry and health (the module docstring's
    list). The parent's engines set K1's count to 0 just before and read
    it just after; the child counts its own over its run."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.cli.predict import load_image
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
    from jumbo_mae_tpu_tpu_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import resolve_save

    t_start = time.perf_counter()
    res: dict = {}
    ft = tmp / "ft" / "finetune_vit_b16" / "ckpt"
    files = sorted(str(p) for p in (tmp / "serve" / "images").glob("*.png"))
    check(len(files) == SERVE_IMAGES, f"telemetry: phase 19's {len(files)} files")
    cfg = load_config(HERE / FT_RECIPE)
    images = np.stack([load_image(f, 224, cfg.data.test_crop_ratio) for f in files])
    direct = np.load(tmp / "serve" / "b16_logits.npz")["logits"]

    # ---- 5. the hooks' cost: the registry on and NULL_REGISTRY, in turns
    fa.LAUNCHES = 0
    on = InferenceEngine(cfg, ckpt=str(ft), max_batch=64, registry=MetricsRegistry())
    null = InferenceEngine(cfg, ckpt=str(ft), max_batch=64, registry=NULL_REGISTRY)
    for e in (on, null):
        e.warmup(("logits",), buckets=(1, 64))
    res["dispatch_ms"] = {}
    for b in (1, 64):
        ms = timed_alternating({"registry": lambda: on.logits(images[:b]), "null": lambda: null.logits(images[:b])},
                               40)
        res["dispatch_ms"][b] = ms
    parent_k1 = fa.LAUNCHES
    check(parent_k1 == 12 * (ran(on) + ran(null)), f"telemetry: the timing engines made {parent_k1} K1")
    res["hooks_us"] = hooks_host_us()
    log("telemetry: ms a dispatch by graph replay (upload, replay, fetch; medians of 40 in turns), registry on / "
        "NULL_REGISTRY: " + ", ".join(f"bucket {b} {v['registry']:.4f} / {v['null']:.4f}"
                                      for b, v in res["dispatch_ms"].items())
        + f"; the engine hooks of one dispatch {res['hooks_us']:.2f} host µs (this machine's CPU), on {smi}")
    del on, null
    torch.cuda.empty_cache()

    # ---- 1-4. the pool in a process of its own, scraped while it serves
    work = tmp / "telemetry"
    watch, staged = work / "push", work / "staged"
    watch.mkdir(parents=True)
    best = resolve_save(ft)
    for name in ("good-1", "corrupt-2", "good-3"):
        shutil.copytree(best, staged / name)
    (work / "files.json").write_text(json.dumps(files))
    n_req, burst = 14 * SERVE_IMAGES, 64
    argv = ["--config", str(HERE / FT_RECIPE), "--ckpt", str(ft), "--images", *(files * 14), "--max-batch", "64",
            "--task", "logits", "--serve", "--replicas", "2", "--warmup", "--metrics-port", "0", "--slo",
            "p99_latency_ms<=250;success_rate>=0.99", "--access-log", str(work / "access"), "--swap-watch",
            str(watch), "--swap-poll-s", "0.1", "--burst", str(burst), "--interarrival-ms", "30",
            "--metrics-hold-s", "5", "--out", str(work / "served.npz")]
    # r1's first flush crashes (the burst reaches it); r0 is preempted at
    # its 320th supervisor tick, 16-18 s after the pool is up: after r1's
    # restart and the three pushes, and early enough for r0's restart to
    # finish while the traffic (~29 s) lasts. The corrupt push has every
    # tensor of its restored tree corrupted: 16 of the trained save's 227
    # left its features at cosine 0.9897, above the 0.98 parity gate
    env = {**os.environ, "PYTHONUNBUFFERED": "1",
           "GRAFT_FAULTS": "serve.replica:raise(RuntimeError)@key~r1,n<1;serve.preempt:raise@key~r0,n=320;"
                           "ckpt.load:corrupt(1000)@key~corrupt"}
    lines: list[str] = []
    with open(work / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", TELEMETRY_CHILD, str(work / "files.json"),
                                 str(work / "fixed.npz"), *argv], cwd=HERE, stdout=subprocess.PIPE, stderr=err,
                                text=True, env=env)
        reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")), daemon=True)
        reader.start()
        read = lambda: "".join(lines)  # noqa: E731
        try:
            wait_for(read, "exporter on :", 120)
            port = int(read().split("exporter on :", 1)[1].split(" ", 1)[0])
            url = f"http://127.0.0.1:{port}"
            deadline = time.monotonic() + 120
            while True:  # 503 until the pool is up
                status, body, _ = scrape(url + "/healthz")
                if status == 200:
                    break
                check(time.monotonic() < deadline and proc.poll() is None, f"telemetry: /healthz {status} {body}")
                time.sleep(0.05)
            health = json.loads(body)
            check(health["ready"] and health["detail"] == "pool up (2 replicas)", f"telemetry: /healthz {health}")
            res["ready_healthz"] = health
            wait_for(read, "swap-watch: polling", 60)

            def until_metric(name, labels, want, timeout_s=60.0):
                end = time.monotonic() + timeout_s
                while True:
                    text = scrape(url + "/metrics")[1]
                    if metric(text, name, labels) == want:
                        return text
                    check(time.monotonic() < end and proc.poll() is None,
                          f"telemetry: {name}{{{labels}}} = {metric(text, name, labels)}, want {want}")
                    time.sleep(0.05)

            # r1's first flush crashed; wait for its restart before any push
            until_metric("serve_replica_restarts_total", 'replica="r1"', 1.0)
            until_metric("serve_replica_up", 'replica="r1"', 1.0)

            def push(name: str) -> str:
                (staged / name).rename(watch / name)
                wait_for(read, f"swap {name}: verdict=", 120)
                return next(x for x in read().splitlines() if f"swap {name}: verdict=" in x)

            verdicts = {"good-1": push("good-1"), "corrupt-2": push("corrupt-2")}
            # the headroom gate on the card: this process holds a ballast
            # until the card's free memory is short of the push
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info()
            ballast = torch.empty(free - 96 * 2**20, dtype=torch.uint8, device="cuda")
            held = torch.cuda.mem_get_info()[0]
            try:
                verdicts["good-3"] = push("good-3")
            finally:
                del ballast
                torch.cuda.empty_cache()
            res["ballast"] = {"free_before": free, "free_held": held, "total": total}
            until_metric("serve_swap_rejected_total", "", 1.0)
            # r0's preemption, then its restart, while the traffic lasts
            until_metric("serve_replica_restarts_total", 'replica="r0"', 1.0, 60.0)
            until_metric("serve_replica_up", 'replica="r0"', 1.0)
            wait_for(read, "holding exporter", 120)
            scrapes, healthz = [], []
            for _ in range(10):
                _, text, ms = scrape(url + "/metrics")
                scrapes.append(ms)
                status, body, ms = scrape(url + "/healthz")
                healthz.append(ms)
            final = json.loads(body)
        finally:
            if proc.poll() is None:
                try:
                    proc.wait(timeout=180)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            reader.join(timeout=30)
    out = read()
    if proc.returncode != 0:
        log(f"telemetry: the child exited {proc.returncode}; its stderr ends:\n{(work / 'stderr.txt').read_text()[-3000:]}")
    check(proc.returncode == 0, f"telemetry: the child exited {proc.returncode}")
    child = json.loads(out.strip().splitlines()[-1])
    rsum = next(x for x in out.splitlines() if "retrace sentinel:" in x)
    check(verdicts["good-1"].startswith("[predict] swap good-1: verdict=promoted stage=promote"),
          f"telemetry: the good push: {verdicts}")
    check("verdict=rolled_back stage=parity" in verdicts["corrupt-2"], f"telemetry: the corrupt push: {verdicts}")
    check("verdict=rejected stage=headroom" in verdicts["good-3"] and "card memory on cuda:0" in verdicts["good-3"],
          f"telemetry: the push under ballast: {verdicts['good-3']} (free {held} of {total} bytes held)")
    check(f"pool served {n_req}/{n_req} ok (0 failed)" in out, f"telemetry: requests failed: {out[-2000:]}")
    check("0 unexpected recompile(s)" in rsum, f"telemetry: {rsum}")
    requeued = sum(metric(text, "serve_replica_requeued_total", f'replica="r{i}"') or 0.0 for i in (0, 1))
    got = {
        "up": [metric(text, "serve_replica_up", f'replica="r{i}"') for i in (0, 1)],
        "requests": metric(text, "infer_requests_total"),
        "crashes_r1": metric(text, "serve_replica_crashes_total", 'replica="r1",kind="crash"'),
        "restarts": [metric(text, "serve_replica_restarts_total", f'replica="r{i}"') for i in (0, 1)],
        "preempted": [metric(text, "serve_replica_preempted_total", f'replica="r{i}"') for i in (0, 1)],
        "swaps": {v: metric(text, f"serve_swap_{v}_total") for v in ("attempts", "promoted", "rollbacks",
                                                                      "rejected")},
        "mem_device": metric(text, "mem_device_bytes", 'device="cuda:0"'),
        "mem_device_peak": metric(text, "mem_device_peak_bytes", 'device="cuda:0"'),
        "retrace_violations": metric(text, "retrace_events_total", 'loop="predict"') or 0.0,
    }
    drift = {ln.split('"')[1]: float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
             if ln.startswith("mem_hbm_predict_vs_measured{")}
    res["metrics"] = {**got, "requeued": requeued, "drift": drift}
    check(got["up"] == [1.0, 1.0], f"telemetry: serve_replica_up {got['up']}")
    check(got["requests"] == n_req + requeued, f"telemetry: infer_requests_total {got['requests']}, sent {n_req} "
          f"(+{requeued} requeued: a requeued request is collected again)")
    check(got["crashes_r1"] == 1.0 and got["restarts"] == [1.0, 1.0] and got["preempted"] == [1.0, 0.0],
          f"telemetry: crashes/restarts/preemptions {got}")
    check(got["swaps"] == {"attempts": 3.0, "promoted": 1.0, "rollbacks": 1.0, "rejected": 1.0},
          f"telemetry: swaps {got['swaps']}")
    check(got["mem_device"] is not None and 0 < got["mem_device"] <= total, f"telemetry: mem_device_bytes {got}")
    check(drift and set(drift) == set(child["peaks"]) and all(np.isfinite(v) and v > 0 for v in drift.values()),
          f"telemetry: drift {drift} against the captured keys with a predicted peak {child['peaks']}")
    check(got["retrace_violations"] == 0.0, f"telemetry: retrace_events_total {got['retrace_violations']}")
    check(final["ok"] and final["ready"] and set(final["info"]) >= {"replicas", "slo", "memory"},
          f"telemetry: the final /healthz {final}")
    check(child["k1"] == 12 * sum(child["ran"]), f"telemetry: K1 {child['k1']} over engines that ran {child['ran']}")
    check(child["gens"] == 4, f"telemetry: {child['gens']} engines (2, r1's restart, r0's restart)")
    fixed = np.load(work / "fixed.npz")
    equal = [bool(np.array_equal(fixed[k], direct)) for k in sorted(fixed.files)]
    check(all(equal), f"telemetry: the pool's engines' logits bit-equal to phase 19's: {equal}")
    res.update(k1=child["k1"] + parent_k1, child_k1=child["k1"], ran=child["ran"], verdicts=verdicts,
               scrape_ms=float(np.median(scrapes)), healthz_ms=float(np.median(healthz)), sentinel=rsum,
               seconds=time.perf_counter() - t_start)
    log(f"telemetry: {n_req} requests ({burst} in a burst, then 30 ms apart) served by 2 replicas under "
        f"serve.replica/serve.preempt/ckpt.load faults: r1 crashed once and restarted, r0 preempted and restarted, "
        f"{requeued:g} requeued, none failed; " + "; ".join(v.replace("[predict] ", "") for v in verdicts.values())
        + f"; ballast left {held} of {total} bytes free; mem_device_bytes {got['mem_device']:.0f}, peak "
        f"{got['mem_device_peak']:.0f}; drift {drift}; {rsum.replace('[predict] ', '')}; K1 {child['k1']} = 12 x "
        f"{child['ran']}; 4 engines' logits bit-equal to phase 19's; scrape {res['scrape_ms']:.2f} ms, /healthz "
        f"{res['healthz_ms']:.2f} ms (medians of 10), on {smi}")
    log(f"telemetry: phase 24 in {res['seconds']:.1f} s")
    return res


# ------------------------------------------------- ViT-H/14 from its recipe

H14_RECIPE = "recipes/pretrain_vit_h14_in1k_fsdp.yaml"
H14_BATCH = 256  # the largest of 64, 128 and 256 that fits one card under "dots"
# the recipe at batch 256 on phase 13's 1,024 toy images: 0.75 epochs = 3
# steps, warmup 0, no sanity eval (the run's one eval and the second eval
# of its save then see the same weights), wandb off (no network there)
H14_SETS = ["mesh.data=1", f"run.train_batch_size={H14_BATCH}", "data.dataset_size=1024", "run.epochs=0.75",
            "optim.warmup_epochs=0", "run.sanity_eval=false", "run.use_wandb=false", "data.use_native=true"]
H14_STEPS = 3
# the slice's attention shapes at batch 256: the encoder (64 visible patches
# + 3 CLS at head_dim 80) and the decoder (256 patches + 3 CLS, head_dim 32)
H14_ENC_SHAPE = (H14_BATCH, 67, 16, 80)
H14_DEC_SHAPE = (H14_BATCH, 259, 16, 32)
H14_K1, H14_K2 = 2 * 32 + 8, 32 + 8  # per step: forwards and the "dots" recompute; backwards
H14_EVAL_K1 = 32 + 8  # per eval batch (and per forward of the figure's engine)
BLOCKWISE_SHAPE = (2, 4099, 16, 64)


def vit_h14_mae():
    """recipes/pretrain_vit_h14_in1k_fsdp.yaml's model and optimizer, built
    in code for the policy timings: 32 x 1280, 16 heads, patch 14, K=3 CLS,
    mask 0.75, sincos2d, grad_ckpt with "dots"; decoder 8 x 512 x 16 heads;
    AdamW with bf16 mu, warmup 0."""
    from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig

    enc = preset("vit_h14", labels=None, mask_ratio=0.75, posemb="sincos2d", grad_ckpt=True, remat_policy="dots")
    dec = DecoderConfig(layers=8, dim=512, heads=16)
    opt = OptimConfig(name="adamw", learning_rate=1.5e-4, lr_scaling="batch", b1=0.9, b2=0.95, weight_decay=0.05,
                      mu_dtype="bfloat16", warmup_steps=0, training_steps=10_000)
    return enc, dec, opt


def check_bwd_case(fa, case: str, q, k, v, do, o, lse, g_lse, dtype) -> tuple[dict, float]:
    """K2/K3 on one case against the plain backward (``check_grads``; one
    key without an lse cotangent held to the exact zero), a rerun
    bit-identical, and K2's D against ``attention_delta``. Returns the
    gradients' errors and D's."""
    import torch

    got = fa.flash_attention_bwd(q, k, v, o, lse, do, g_lse=g_lse)
    want_d = fa.attention_delta(o, do, g_lse)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, delta=want_d)
    grads = check_grads(case, got, ref, dtype, sk=k.shape[1] if g_lse is None else None)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, g_lse=g_lse)
    check(all(torch.equal(x, y) for x, y in zip(got, again)), f"two runs of K2/K3 differ at {case}")
    return grads, check_delta(case, fa.flash_attention_bwd_dq(q, k, v, do, o, lse, g_lse)[1], want_d)


def h14_kernels(fa) -> dict:
    """K1-K3 at the slice's encoder and decoder shapes against their plain
    versions, as phases 3-4 hold them (f32 with TF32 off: K1 1e-5, K2/K3
    1e-4; bf16: K1 atol 2e-2, K2/K3 within 3e-2 of the largest entry; K2's
    D 1e-5; reruns bit-identical), without and with an lse cotangent."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for dtype, tol in ((torch.float32, dict(atol=1e-5, rtol=1e-5)), (torch.bfloat16, dict(atol=2e-2, rtol=0.0))):
        name = str(dtype).split(".")[-1]
        for i, shape in enumerate((H14_ENC_SHAPE, H14_DEC_SHAPE)):
            q, k, v = qkv(shape, dtype, seed=500 + i)
            o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
            ref_o, ref_lse = fa.flash_attention_fwd_plain(q, k, v, with_lse=True)
            torch.testing.assert_close(o, ref_o, **tol)
            torch.testing.assert_close(lse, ref_lse, **tol)
            o2, lse2 = fa.flash_attention_fwd(q, k, v, with_lse=True)
            check(torch.equal(o, o2) and torch.equal(lse, lse2), f"two runs of K1 differ at {shape} {name}")
            errs[("K1", name, shape)] = max((o.float() - ref_o.float()).abs().max().item(),
                                            (lse - ref_lse).abs().max().item())
            q, k, v, do, o, lse = bwd_inputs(shape, dtype, 510 + i, fa)
            b, sq, h, _ = shape
            for g_lse in (None, torch.randn((b * h, sq), generator=torch.Generator(device="cuda").manual_seed(i),
                                            device="cuda")):
                case = f"{shape} {name}{' g_lse' if g_lse is not None else ''}"
                grads, d_err = check_bwd_case(fa, case, q, k, v, do, o, lse, g_lse, dtype)
                errs[("K2", name, shape)] = max(errs.get(("K2", name, shape), 0.0), grads["dq"][0])
                errs[("K3", name, shape)] = max(errs.get(("K3", name, shape), 0.0), grads["dk"][0], grads["dv"][0])
                log(f"h14 K2/K3 {case}: " + ", ".join(f"{g} {e:.3e}/{sc:.3e}" for g, (e, sc) in grads.items())
                    + f", D {d_err:.3e}; rerun bit-identical")
            log(f"h14 K1 {shape} {name}: max|o,lse - plain| {errs[('K1', name, shape)]:.3e}; rerun bit-identical")
    return errs


def h14_blockwise() -> dict:
    """``blockwise_attention`` (plain PyTorch, key chunks of 1,024, the path
    off CUDA from 2,048 tokens) on the card against the full score matrix
    at (2, 4099, 16, 64), without and with a (1, 16, Sq, Sk) f32 bias:
    f32 (TF32 off) at atol/rtol 1e-5, bf16 within 1e-2 of the largest
    entry; the peak memory of each call above what its inputs hold."""
    import torch

    from jumbo_mae_tpu_tpu_torch.ops.blockwise_attention import blockwise_attention

    def full(q, k, v, bias):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        p = torch.softmax(s if bias is None else s + bias, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float()).to(q.dtype)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    b, s, h, _ = BLOCKWISE_SHAPE
    res = {}
    g = torch.Generator(device="cuda").manual_seed(7)
    bias = torch.randn((1, h, s, s), generator=g, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(BLOCKWISE_SHAPE, dtype, seed=600)
        for name, bb in (("no bias", None), ("bias", bias)):
            got, got_mem = peak(lambda: blockwise_attention(q, k, v, block_k=1024, bias=bb))
            want, want_mem = peak(lambda: full(q, k, v, bb))
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            else:
                check(err <= 1e-2 * scale, f"bf16 blockwise {name}: {err:.3e} > 1e-2 x {scale:.3e}")
            check(got_mem < want_mem, f"blockwise {name} peak {got_mem} not below the full scores' {want_mem}")
            key = f"{str(dtype).split('.')[-1]} {name}"
            res[key] = dict(max_abs_err=err, peak_bytes=got_mem, full_peak_bytes=want_mem)
            log(f"blockwise {BLOCKWISE_SHAPE} {key}: max|err| {err:.3e} of {scale:.3e}; peak {got_mem / 2**20:.1f} "
                f"MiB against {want_mem / 2**20:.1f} MiB for the full scores")
    return res


def h14_policies(fa, smi: str, state) -> dict:
    """The ViT-H/14 MAE step at batch 256 on one synthetic batch under
    ``"dots"`` and ``"none"`` in turns (dots, none, none, dots; one model,
    its encoder config switched): K1-K3 per step, peak card memory, step
    ms by CUDA events over 3 steps after one, and the host ms of those 3
    step calls before the closing sync (the enqueue); then one step at
    batch 8 without gradient checkpointing for its launch counts; then, at
    batch 8 from one state and batch, the loss and every parameter gradient
    under "dots", "none" and no checkpointing, which must agree bit for bit
    (the recompute runs the same ops, K1 among them, on the same inputs).
    ``state`` is the recipe's run's own, as it saved it (its model and
    optimizer; the steps move it in place)."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
    from jumbo_mae_tpu_tpu_torch.obs.mfu import mfu, pretrain_flops_per_image
    from jumbo_mae_tpu_tpu_torch.train.steps import make_train_step

    enc, dec = state.model.encoder.cfg, state.model.decoder_cfg
    check(enc.grad_ckpt and enc.remat_policy == "dots", f"h14: the recipe's encoder {enc}")
    nparams = sum(p.numel() for p in state.model.parameters())
    log(f"h14: the policies on the run's saved state, {nparams} params")
    step = make_train_step(mode="pretrain")
    flops = pretrain_flops_per_image(enc, dec)
    out = {"params": nparams, "gflop_per_image": flops / 1e9}
    none = enc.replace(remat_policy="none")
    cases = (("dots", enc, H14_BATCH, 3), ("none", none, H14_BATCH, 3), ("none", none, H14_BATCH, 3),
             ("dots", enc, H14_BATCH, 3), ("no checkpointing", enc.replace(grad_ckpt=False), 8, 1))
    for name, cfg, batch_size, timed in cases:
        state.model.encoder.cfg = cfg
        batch = next(synthetic_batches(batch_size, enc.image_size, seed=0, distinct=1))
        state, m = step(state, batch)  # allocations settle
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses = []
        t_host = time.perf_counter()
        for _ in range(timed):
            state, m = step(state, batch)
            losses.append(m["loss"])
        host_ms = (time.perf_counter() - t_host) * 1e3 / timed
        end.record()
        torch.cuda.synchronize()
        counts = {k: n / timed for k, n in (("K1", fa.LAUNCHES), ("K2", fa.LAUNCHES_BWD_DQ),
                                             ("K3", fa.LAUNCHES_BWD_DKV))}
        vals = [x.item() for x in losses]
        check(all(np.isfinite(vals)), f"h14 {name}: non-finite loss {vals}")
        step_ms = start.elapsed_time(end) / timed
        peak = torch.cuda.max_memory_allocated()
        run = dict(counts=counts, step_ms=step_ms, host_ms=host_ms, peak_bytes=peak, batch=batch_size, losses=vals)
        out.setdefault(name, []).append(run)
        want_k1 = (2 if cfg.grad_ckpt else 1) * enc.layers + dec.layers
        log(f"h14 {name} at batch {batch_size}: K1 {counts['K1']:g}, K2 {counts['K2']:g}, K3 {counts['K3']:g} a "
            f"step (want {want_k1}, {H14_K2}, {H14_K2}); {step_ms:.2f} ms a step (CUDA events over {timed}; host "
            f"{host_ms:.2f} ms a step call), "
            f"{batch_size * 1e3 / step_ms:.1f} images/s, MFU {100 * mfu(batch_size * 1e3 / step_ms, flops):.2f}% at "
            f"{flops / 1e9:.1f} GFLOP/image, peak {peak / 2**30:.2f} GiB, on {smi}")
        check(counts == {"K1": want_k1, "K2": H14_K2, "K3": H14_K2}, f"h14 {name}: launches per step {counts}")
        if cfg.grad_ckpt:
            run["cost"] = step_cost_row(state, cfg, dec, batch_size, peak, step_ms, flops, f"h14 {name}", smi)
    out["gradients"] = h14_policy_gradients(state, (("dots", enc), ("none", none),
                                                    ("no checkpointing", enc.replace(grad_ckpt=False))), smi)
    state.model.encoder.cfg = enc
    return out


def step_cost_row(state, enc, dec, batch_size: int, peak: int, step_ms: float, flops_per_image: float, what: str,
                  smi: str) -> dict:
    """The train step's cost row as ``cli.train`` journals it
    (``obs/costmodel.py`` ``train_step_cost``, the card's measured peak)
    and its MFU and HFU at ``step_ms``: HFU counts the remat recompute,
    so it must not fall below MFU."""
    from jumbo_mae_tpu_tpu_torch.obs.costmodel import cost_asdict, train_step_cost, utilization_report
    from jumbo_mae_tpu_tpu_torch.obs.memwatch import tree_nbytes
    from jumbo_mae_tpu_tpu_torch.obs.mfu import H100_PEAK_BF16_TFLOPS

    opt = state.opt_state
    cost = train_step_cost(enc, dec, batch=batch_size, param_bytes=tree_nbytes(list(state.model.parameters())),
                           opt_bytes=tree_nbytes([getattr(opt, k) for k in opt.SLOTS] + [opt.master]),
                           device_type="cuda", peak_bytes=peak)
    util = utilization_report(flops_per_image * batch_size, cost.flops, 1e3 / step_ms,
                              peak_tflops=H100_PEAK_BF16_TFLOPS)
    row = dict(cost_asdict(cost), mfu=util.model_flops_utilization, hfu=util.hardware_flops_utilization)
    log(f"{what}: compiled_program {json.dumps(cost_asdict(cost))}; at {step_ms:.2f} ms a step MFU "
        f"{row['mfu']:.4f}, HFU {row['hfu']:.4f} ({row['hfu'] / row['mfu']:.4f}x), on {smi}")
    check(row["hfu"] >= row["mfu"], f"{what}: HFU {row['hfu']} below MFU {row['mfu']}")
    return row


def h14_policy_gradients(state, policies, smi: str, batch_size: int = 8) -> dict:
    """One forward and backward of ``state``'s model on one synthetic batch
    and one mask draw (the state's step generators, the step not advanced)
    under each ``(name, encoder config)`` of ``policies``: the loss and
    every parameter gradient of each against the first's, bit for bit. The
    optimizer does not run, so every policy sees the same weights."""
    import torch

    from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches

    model = state.model.train()
    named = list(model.named_parameters())
    batch = next(synthetic_batches(batch_size, model.encoder.cfg.image_size, seed=1, distinct=1))
    images = torch.from_numpy(batch["images"]).to(state.device)
    first, res = None, {}
    for name, cfg in policies:
        model.encoder.cfg = cfg
        for _, p in named:
            p.grad = None
        loss = model(images, generators=state.step_generators())["loss"]
        loss.backward()
        got = (loss.detach(), [p.grad for _, p in named])
        for _, p in named:
            p.grad = None
        if first is None:
            first = (name, *got)
            continue
        pairs = list(zip([n for n, _ in named], got[1], first[2]))
        differ = [n for n, a, b in pairs if (a is None) != (b is None) or (a is not None and not torch.equal(a, b))]
        worst = max(((a - b).abs().max().item() for _, a, b in pairs if a is not None and b is not None), default=0.0)
        res[name] = dict(loss=got[0].item(), loss_equal=torch.equal(got[0], first[1]), params_differ=len(differ),
                         max_abs_diff=worst)
        log(f"h14 gradients at batch {batch_size}, {name} against {first[0]}: loss {got[0].item():.9g} / "
            f"{first[1].item():.9g}, {len(differ)} of {len(named)} parameter gradients differ (max |diff| "
            f"{worst:.3e}), on {smi}")
        check(res[name]["loss_equal"] and not differ,
              f"h14: {name} against {first[0]}: loss {got[0].item()!r} / {first[1].item()!r}, gradients differ at "
              f"{differ[:5]}")
    return {"against": first[0], "batch": batch_size, "loss": first[1].item(), **res}


def read_png_rgb(path: Path):
    """(H, W, 3) uint8 of a PNG written by ``tools/reconstruct.write_png``
    (8-bit RGB, filter 0 on every row, one IDAT chunk)."""
    import struct
    import zlib

    import numpy as np

    data = path.read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    check((depth, color) == (8, 2), f"{path}: bit depth {depth}, color type {color}")
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), f"{path}: a row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def h14_summary(h14: dict) -> dict:
    """Phase 25's result as one JSON line: everything but the timings,
    which the kernels line carries."""
    return {k: v for k, v in h14.items() if k not in ("k1_timings", "bwd_timings")}


def h14_kernel_fields(h14: dict, key: str) -> dict:
    """K1-K3's numbers at phase 25's shapes for the kernels line: device ms
    by graph replay (eager beside), plain, SDPA and bound, and the bf16
    error against the plain version, at the encoder and the decoder."""
    out = {}
    for tag, shape in (("h14_enc", H14_ENC_SHAPE), ("h14_dec", H14_DEC_SHAPE)):
        t = h14["k1_timings"][shape] if key == "K1" else h14["bwd_timings"][(key, shape)]
        out[tag] = {k: t[k] for k in ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        out[tag]["shape"] = list(shape)
        out[tag]["max_abs_err"] = h14["kernel_errs"][f"{key} bfloat16 {shape}"]
    return out


def phase_h14(fa, smi: str, tmp: Path, urls: dict) -> dict:
    """Phase 25: ViT-H/14 MAE pretraining from
    recipes/pretrain_vit_h14_in1k_fsdp.yaml through ``cli/train.py``'s
    ``main`` at full width and depth, batch 256, ``remat_policy: dots``,
    the native tar reader and the validation cache, on phase 13's shards:
    K1-K3 at the slice's shapes against their plain versions and timed,
    ``blockwise_attention`` against the full scores, two native streams
    alike, then the run (3 steps, one eval filling the cache, a save), a
    second eval of the saved state through the CLI's eval step and valid
    iterator (no shard opened, the same loss bit for bit), the step under
    "dots" and "none" on that state, and the reconstruction figure from
    the save."""
    import hashlib

    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch import infer
    from jumbo_mae_tpu_tpu_torch.cli import train as cli
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.data import tario
    from jumbo_mae_tpu_tpu_torch.data.loader import DataConfig, native_train_stream, valid_loader
    from jumbo_mae_tpu_tpu_torch.data.shards import expand_shards
    from jumbo_mae_tpu_tpu_torch.tools import reconstruct
    from jumbo_mae_tpu_tpu_torch.train.steps import make_eval_step

    t0 = time.perf_counter()
    res = {"kernel_errs": {f"{k} {d} {s}": e for (k, d, s), e in h14_kernels(fa).items()}}
    shapes = ((H14_ENC_SHAPE, True), (H14_DEC_SHAPE, True))
    res["k1_timings"] = phase_timings(fa, shapes=shapes, f32=False)
    res["bwd_timings"] = phase_bwd_timings(fa, shapes=(H14_ENC_SHAPE, H14_DEC_SHAPE),
                                           fb_shapes=(H14_ENC_SHAPE, H14_DEC_SHAPE))
    res["blockwise"] = h14_blockwise()
    t_kernels = time.perf_counter() - t0

    # ---- two native streams over the same shards: the same samples
    cfg = DataConfig(train_shards=urls["train"], image_size=load_config(HERE / H14_RECIPE).data.image_size,
                     use_native=True, seed=0)
    digests = []
    for _ in range(2):
        stream = native_train_stream(cfg)
        h = hashlib.sha1()
        for _, (img, label) in zip(range(64), stream):
            h.update(img.tobytes() + int(label).to_bytes(8, "little", signed=True))
        stream.close()
        digests.append(h.hexdigest()[:16])
    check(digests[0] == digests[1], f"two native streams of the same shards differ: {digests}")
    log(f"h14: two native streams (4 reader threads) of phase 13's shards, 64 samples each: digests {digests}")
    res["native_digests"] = digests

    # ---- the main path: the recipe through cli/train.py, counts from 0
    opens = []
    real_open = tario.open_url
    tario.open_url = lambda url, mode="rb": opens.append(url) or real_open(url, mode)
    try:
        out = tmp / "h14"
        sets = H14_SETS + [f"data.train_shards={urls['train']}", f"data.valid_shards={urls['val']}",
                           f"data.valid_cache={tmp / 'valcache'}", f"run.output_dir={out}"]
        rec = run_driver(fa, ["--config", str(HERE / H14_RECIPE), "--set", *sets])
        run_opens = len(opens)
        # the second eval: the CLI's own eval step and valid iterator on the
        # state the run saved (the same weights), which now read the cache
        recipe = load_config(HERE / H14_RECIPE, sets)
        saved = rec["saves"][-1]["state"]
        fa.LAUNCHES = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = 0
        t1 = time.perf_counter()
        second = cli.evaluate(make_eval_step(mode="pretrain"), saved,
                              cli.make_valid_iterator(recipe, recipe.run.valid_batch_size, device=saved.device)())
        eval_s = time.perf_counter() - t1
        e = {"K1": fa.LAUNCHES, "K2": fa.LAUNCHES_BWD_DQ, "K3": fa.LAUNCHES_BWD_DKV}
        eval_opens = len(opens) - run_opens
    finally:
        tario.open_url = real_open
    # the policies on the state the run saved: the run built it, from the
    # recipe, so no second build of the 775M parameters
    t1 = time.perf_counter()
    res["policies"] = h14_policies(fa, smi, saved)
    t_policies = time.perf_counter() - t1
    del saved
    rec["saves"].clear()
    torch.cuda.empty_cache()
    steps = len(rec["metrics"])
    losses = [m["loss"] for m in rec["metrics"]]
    check(steps == H14_STEPS, f"h14: cli/train.py ran {steps} steps, want {H14_STEPS}")
    check(all(np.isfinite(losses)) and all(m.get("skipped", 0.0) == 0.0 for m in rec["metrics"]),
          f"h14: losses {losses}")
    c = rec["counts"]
    train_k1 = c["K1"] - rec["eval_k1"]
    log(f"h14: cli/train.py ran {steps} steps (losses {', '.join(f'{x:.5f}' for x in losses)}); launches K1 {c['K1']} "
        f"({train_k1} in the steps, {rec['eval_k1']} in {rec['eval_batches']} eval batch(es)), K2 {c['K2']}, K3 "
        f"{c['K3']}; the second eval K1 {e['K1']}, K2 {e['K2']}, K3 {e['K3']} in {eval_s:.2f} s")
    check(train_k1 == H14_K1 * steps and c["K2"] == c["K3"] == H14_K2 * steps, "h14: launches per train step")
    check(rec["eval_k1"] == H14_EVAL_K1 * rec["eval_batches"] and rec["eval_batches"] == 1, "h14: eval launches")
    check(e["K1"] == H14_EVAL_K1 * rec["eval_batches"] and e["K2"] == e["K3"] == 0, "h14: second eval launches")
    vals = [rec["evals"][0]["val/loss"], second["val/loss"]]
    log(f"h14: shard opens by the run's eval {run_opens}, by the second eval {eval_opens}; val/loss {vals}")
    n_val = len(expand_shards(urls["val"]))
    check(run_opens == n_val and eval_opens == 0,
          f"h14: the first eval opened {run_opens} of {n_val} shard(s), the second {eval_opens}")
    check(len(vals) == 2 and vals[0] == vals[1] and np.isfinite(vals[0]), f"h14: the two evals' losses {vals}")
    # the run's one compiled_program row, and HFU against MFU in its windows
    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal

    events = read_journal(out / recipe.run.name)
    programs = [ev for ev in events if ev["type"] == "compiled_program"]
    perf = [ev["metrics"] for ev in events if ev["type"] == "step" and "perf/hardware_flops_utilization" in ev["metrics"]]
    check(len(programs) == 1 and programs[0]["source"] == "analytic" and (programs[0]["peak_bytes"] or 0) > 0,
          f"h14: the run's compiled_program rows {programs}")
    check(bool(perf) and all(m["perf/hardware_flops_utilization"] >= m["perf/model_flops_utilization"] for m in perf),
          f"h14: the run's HFU against MFU {perf}")
    log(f"h14: the run's compiled_program {json.dumps(programs[0])}; its last window MFU "
        f"{perf[-1]['perf/model_flops_utilization']:.4f}, HFU {perf[-1]['perf/hardware_flops_utilization']:.4f}, "
        f"predicted {perf[-1]['perf/predicted_step_ms']:.2f} ms (drift {perf[-1]['perf/predict_vs_measured']:.3f}), "
        f"on {smi}")
    res["cost"] = dict(program=programs[0], mfu=perf[-1]["perf/model_flops_utilization"],
                       hfu=perf[-1]["perf/hardware_flops_utilization"])
    saver = rec["ckpt"]
    res["run"] = dict(counts=c, eval_k1=rec["eval_k1"], second_eval_counts=e, losses=losses, val_loss=vals,
                      shard_opens=[run_opens, eval_opens], wall_s=rec["wall_s"], second_eval_s=eval_s,
                      save_s=saver.last_save_s, write_s=saver.last_write_s, save_bytes=saver.last_save_bytes,
                      dispatch_s=float(np.mean(rec["dispatch_s"][1:])), loader_wait_s=float(np.mean(rec["loader_wait_s"])))
    log(f"h14: the run's main() {rec['wall_s']:.1f} s (state build, 3 steps, eval, save of {saver.last_save_bytes} "
        f"bytes: {saver.last_save_s:.2f} s blocking, {saver.last_write_s:.2f} s writing), on {smi}")

    # ---- the figure from the save
    made = []
    real_engine = infer.InferenceEngine

    class Recorded(real_engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    infer.InferenceEngine = Recorded
    try:
        fa.LAUNCHES = 0
        t1 = time.perf_counter()
        png = reconstruct.main([str(HERE / H14_RECIPE), "--ckpt", str(out / recipe.run.name / "ckpt"),
                                "--out", str(tmp / "h14_recon.png"), "--n", "8", "--set", *sets])
        fig_s = time.perf_counter() - t1
    finally:
        infer.InferenceEngine = real_engine
    fig_k1 = fa.LAUNCHES
    grid = read_png_rgb(png)
    size = recipe.data.image_size
    check(grid.shape == (8 * (size + 2) - 2, 4 * (size + 2) - 2, 3), f"h14: the figure is {grid.shape}")
    inputs = next(valid_loader(DataConfig(valid_shards=urls["val"], image_size=size), 8))["images"]
    for i in range(8):
        y = i * (size + 2)
        check(np.array_equal(grid[y:y + size, :size], inputs[i]), f"h14: figure row {i}'s original")
    check(len(made) == 1 and fig_k1 == H14_EVAL_K1 * ran(made[0]),
          f"h14: the figure's engine launched K1 {fig_k1} times over {ran(made[0])} forwards")
    res["figure"] = dict(shape=list(grid.shape), k1=fig_k1, forwards=ran(made[0]), seconds=fig_s,
                         bytes=png.stat().st_size)
    log(f"h14: figure {grid.shape[1]}x{grid.shape[0]} px from the save in {fig_s:.1f} s, K1 {fig_k1} = "
        f"{H14_EVAL_K1} x {ran(made[0])} forwards, originals bit-equal to the validation images")
    res["seconds"] = time.perf_counter() - t0
    log(f"h14: phase 25 in {res['seconds']:.1f} s (kernels {t_kernels:.1f}, policies {t_policies:.1f})")
    return res


# Phase 26: phase 13's run with a scripted divergence. NaN losses at the
# 3rd and 4th train-step calls (steps 3 and 4), patience 2 and a save every
# 2 steps: the engine handles a rollback before that step's eval and save,
# so the streak rolls back at step 4 to the clean step-2 save; the host.leak
# site retains 16 MB a step for the leak sentinel to name; the step's
# per-layer-group diagnostics on every step
ROLLBACK_SETS = ["run.faults=train.loss:nan@n=2..3;host.leak:corrupt(16)", "run.log_interval=1",
                 "run.eval_interval=2", "run.sentinel_patience=2", "run.telemetry=true", "run.telemetry_port=0",
                 "run.telemetry_host=127.0.0.1", "run.diag_every=1"]
# what a scrape of phase 26's exporter must show while the run is live
WATCH_FAMILIES = ("train_steps_total", "train_mfu", "goodput_fraction", 'span_seconds_count{name="train_step"}',
                  "run_generation", 'model_grad_norm{group="blocks.0"}', "train_hardware_flops_utilization")
ROLLBACK_STEPS = [1, 2, 3, 4, 3, 4, 5, 6]  # the steps dispatched, in order
ROLLBACK_LOSS_RTOL = 4e-3  # one bf16 ulp (2^-8) of the loss


def _counter(name: str, key: str = "") -> float:
    from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

    return float(get_registry().snapshot().get(name, {}).get(key, 0.0))


@contextlib.contextmanager
def scraped_exporter(period_s: float = 0.5):
    """Scrape the exporter ``cli.train`` starts (``run.telemetry``) from a
    thread while the run is live: every ``/healthz`` answer (status and
    ``degraded``), and the last ``/metrics`` text that shows every one of
    ``WATCH_FAMILIES``. The server is recorded as the CLI starts it; the
    thread stops when the block exits."""
    from jumbo_mae_tpu_tpu_torch.cli import train as cli

    servers, stop = [], threading.Event()
    seen = {"healthz": [], "metrics": None, "scrapes": 0, "scrape_ms": []}

    class Recorded(cli.TelemetryServer):
        def start(self):
            servers.append(super().start())
            return servers[-1]

    def poll():
        while not stop.wait(period_s):
            if not servers:
                continue
            base = f"http://127.0.0.1:{servers[-1].port}"
            try:
                status, body, ms = scrape(base + "/metrics")
                hstatus, hbody, _ = scrape(base + "/healthz")
            except OSError:  # closed with the run
                continue
            seen["scrapes"] += 1
            seen["scrape_ms"].append(ms)
            if status == 200 and all(f in body for f in WATCH_FAMILIES):
                seen["metrics"] = body
            seen["healthz"].append((hstatus, json.loads(hbody).get("degraded")))

    saved = cli.TelemetryServer
    cli.TelemetryServer = Recorded
    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield seen
    finally:
        stop.set()
        thread.join()
        cli.TelemetryServer = saved


def rollback_diagnostics(events: list[dict], nonfinite: dict, run_dir: Path, tmp: Path, run_doctor, perf_doctor,
                         smi: str) -> dict:
    """Phase 26's diagnostics (``run.diag_every=1``): the flight record
    names ``patch_embed``, every step row carries the 29 groups, one
    ``compiled_program`` row (analytic, the card's peak), HFU ≥ MFU in
    every window that has both, and the run and perf doctors read the
    journal (exit 0, the group named)."""
    grp = nonfinite["extra"].get("first_nonfinite_group")
    check(grp == "patch_embed", f"rollback: the nonfinite_step record names {grp!r}, want 'patch_embed'")
    start = next(e for e in events if e["type"] == "run_start")
    groups = start["diag_groups"]
    steps = [e for e in events if e["type"] == "step"]
    check(len(groups) == 29 and all(list(e.get("diag", {})) == groups for e in steps),
          f"rollback: diag over {len(groups)} groups, in {sum('diag' in e for e in steps)} of {len(steps)} step rows")
    bad = [e["step"] for e in steps if e["diag"]["patch_embed"]["grad_norm"] == "nan"]
    check(bad == [3, 4], f"rollback: non-finite patch_embed grad norms at steps {bad}")
    programs = [e for e in events if e["type"] == "compiled_program"]
    check(len(programs) == 1 and programs[0]["source"] == "analytic" and (programs[0]["peak_bytes"] or 0) > 0,
          f"rollback: compiled_program rows {programs}")
    perf = [e["metrics"] for e in steps if "perf/hardware_flops_utilization" in e["metrics"]]
    check(bool(perf) and all(m["perf/hardware_flops_utilization"] >= m["perf/model_flops_utilization"] for m in perf),
          f"rollback: HFU against MFU {[(m['perf/hardware_flops_utilization'], m['perf/model_flops_utilization']) for m in perf]}")
    rc = run_doctor.main([str(run_dir), "--out", str(tmp / "run.md")])
    report = (tmp / "run.md").read_text()
    check(rc == 0 and "first layer group to go non-finite (grad norm): **patch_embed**" in report,
          f"rollback: run_doctor exit {rc}")
    prc = perf_doctor.main([str(run_dir), "--out", str(tmp / "perf.md")])
    preport = (tmp / "perf.md").read_text()
    check(prc == 0 and "analytic cost accounting" in preport and "predicted-vs-measured drift" in preport,
          f"rollback: perf_doctor exit {prc}")
    p, last = programs[0], perf[-1]
    log(f"rollback: diag over {len(groups)} groups in every step row, patch_embed non-finite at steps {bad}, the "
        f"black box names {grp}; compiled_program {p['flops'] / 1e12:.3f} TFLOP, {p['bytes_accessed'] / 1e9:.2f} GB, "
        f"peak {p['peak_bytes'] / 2**30:.2f} GiB; the last window MFU {last['perf/model_flops_utilization']:.4f}, HFU "
        f"{last['perf/hardware_flops_utilization']:.4f} ({last['perf/hardware_flops_utilization'] / last['perf/model_flops_utilization']:.4f}x), "
        f"predicted {last['perf/predicted_step_ms']:.2f} ms, drift {last['perf/predict_vs_measured']:.3f}; "
        f"run_doctor and perf_doctor exit 0, on {smi}")
    return dict(groups=len(groups), first_nonfinite_group=grp, compiled_program=p,
                mfu=[m["perf/model_flops_utilization"] for m in perf],
                hfu=[m["perf/hardware_flops_utilization"] for m in perf],
                predicted_step_ms=last["perf/predicted_step_ms"], drift=last["perf/predict_vs_measured"],
                run_doctor_rc=rc, perf_doctor_rc=prc)


def watch_hooks_host_us(reps: int = 20000) -> float:
    """Host µs of what the always-on watch layers add to one dispatch of
    ``cli.train`` at phase 26's cadence (a log window a step): the two
    spans, the ledger's charges, the health beats, the step gauges and
    counter, the flight recorder's ``record_step`` and the ledger's
    ``publish``, on a live registry: the median of 5 runs of ``reps``."""
    import numpy as np

    from jumbo_mae_tpu_tpu_torch.obs.exporter import HealthState
    from jumbo_mae_tpu_tpu_torch.obs.flightrec import FlightRecorder
    from jumbo_mae_tpu_tpu_torch.obs.goodput import GoodputLedger
    from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry
    from jumbo_mae_tpu_tpu_torch.obs.trace import span_timer

    reg = MetricsRegistry()
    ledger, health = GoodputLedger(registry=reg), HealthState()
    health.watch("train_step", 3600.0)
    health.watch("data_batch", 3600.0)
    fr = FlightRecorder(Path(tempfile.gettempdir()), capacity=256)
    sp_wait, sp_step = span_timer("data_wait", registry=reg), span_timer("train_step", registry=reg)
    gauges = [reg.gauge(n) for n in ("train_mfu", "train_images_per_sec", "train_data_wait_fraction", "train_step",
                                     "train_grad_norm")]
    steps = reg.counter("train_steps_total")
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for i in range(reps):
            with sp_wait:
                pass
            ledger.add("data_wait", sp_wait.last_s)
            health.beat("data_batch")
            with sp_step:
                pass
            ledger.note_step(i, sp_step.last_s)
            steps.inc()
            health.beat("train_step")
            for g in gauges:
                g.set(0.5)
            fr.record_step(i, {"loss": 0.5, "grad_norm": 1.0})
            ledger.publish()
        runs.append((time.perf_counter() - t0) / reps * 1e6)
    return float(np.median(runs))


def phase_rollback(fa, smi: str, tmp: Path, driver: dict) -> dict:
    """Phase 26: the training run's safety layers on phase 13's recipe,
    shards and seed through ``cli.train.main``: the divergence sentinel
    and its rollback to the step-2 save (bad steps exactly 3 and 4), the
    rerun's losses of steps 3-6 against phase 13's, the launches per
    dispatch (a skipped step runs its backward), the journal's rows, the
    memory samples and the leak sentinel naming ``fault_ballast``
    (``tools/mem_doctor.py`` reads the journal), no unexpected retrace;
    with what watches the run on: three flight records (the first bad
    window, the leak, the rollback), a goodput report at each save and at
    shutdown (``tools/goodput_doctor.py`` exits 0), and the exporter
    scraped while the run is live (``/healthz`` turning degraded once the
    leak sentinel fires)."""
    import numpy as np
    import torch

    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.faults import inject
    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal
    from jumbo_mae_tpu_tpu_torch.tools import goodput_doctor, mem_doctor, perf_doctor, run_doctor

    t0 = time.perf_counter()
    urls = driver["urls"]
    out = tmp / "rollback"
    sets = DRIVER_SETS + [f"data.train_shards={urls['train']}", f"data.valid_shards={urls['val']}",
                          f"run.output_dir={out}", *ROLLBACK_SETS]
    counters = ("train_steps_skipped_total", "train_rollbacks_total")
    before = {k: _counter(k) for k in counters}
    retrace0 = (_counter("retrace_events_total", "train"), _counter("retrace_compiles_total", "train"))
    try:
        with scraped_exporter() as seen:
            rec = run_driver(fa, ["--config", str(HERE / RECIPE), "--set", *sets])
    finally:
        ballast = inject.leak_ballast_bytes()
        inject.install_plan("host.leak:raise")  # a raise firing clears the ballast
        inject.host_leak_tick()
        inject.clear_plan()
    delta = {k: _counter(k) - before[k] for k in counters}
    retraces = (_counter("retrace_events_total", "train") - retrace0[0],
                _counter("retrace_compiles_total", "train") - retrace0[1])
    run_dir = out / load_config(HERE / RECIPE, sets).run.name
    events = read_journal(run_dir)
    rows = [(e["type"], e.get("step"), e.get("from_step"), e.get("to_step")) for e in events
            if e["type"] in ("step", "sentinel_bad_step", "rollback", "shutdown", "checkpoint_save")]
    log(f"rollback: journal rows {[r for r in rows if r[0] != 'checkpoint_save']}")

    # the sentinel: bad steps exactly 3 and 4, one rollback from 4 to 2,
    # then steps 3-6 and the shutdown at 6
    bad = [e["step"] for e in events if e["type"] == "sentinel_bad_step"]
    rb = [(e["from_step"], e["to_step"], e["rollbacks"]) for e in events if e["type"] == "rollback"]
    check(bad == [3, 4] and rb == [(4, 2, 1)], f"rollback: bad steps {bad}, rollbacks {rb}")
    i_rb = next(i for i, r in enumerate(rows) if r[0] == "rollback")
    check([r[1] for r in rows[:i_rb] if r[0] == "step"] == [1, 2, 3, 4], "rollback: step rows before the rollback")
    check([r[1] for r in rows[i_rb:] if r[0] == "step"] == [3, 4, 5, 6], "rollback: step rows after the rollback")
    check([r[1] for r in rows if r[0] == "checkpoint_save"] == [2, 4, 6], "rollback: saves at steps 2, 4, 6")
    check(rows[-1] == ("shutdown", 6, None, None) and events[-1]["reason"] == "completed",
          f"rollback: the journal ends {events[-1]}")
    check(delta == {"train_steps_skipped_total": 2.0, "train_rollbacks_total": 1.0}, f"rollback: counters {delta}")

    # the losses: the rerun of steps 3-6 against phase 13's straight run
    metrics = rec["metrics"]
    check(len(metrics) == len(ROLLBACK_STEPS), f"rollback: {len(metrics)} dispatches, want {len(ROLLBACK_STEPS)}")
    skipped = [m.get("skipped", 0.0) for m in metrics]
    check(skipped == [0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0], f"rollback: the guard's skips {skipped}")
    losses = [m["loss"] for m in metrics]
    check(np.isfinite(losses[-1]), f"rollback: the final loss {losses[-1]}")
    straight = driver["losses"]
    pairs = [(s, losses[i], straight[s - 1]) for i, s in enumerate(ROLLBACK_STEPS) if i < 2 or i >= 4]
    rel = [abs(a - b) / abs(b) for _, a, b in pairs]
    log("rollback: loss per dispatch " + ", ".join(f"{s}:{x:.5f}" for s, x in zip(ROLLBACK_STEPS, losses)))
    log(f"rollback: steps 1-2 and the rerun's 3-6 against phase 13's: largest relative difference {max(rel):.3e} "
        f"(steps {[s for s, _, _ in pairs]}, {rel})")
    check(max(rel) <= ROLLBACK_LOSS_RTOL, f"rollback: the rerun's losses differ from phase 13's by {max(rel):.3e}")

    # launches per dispatch: the skipped steps ran their backward too
    c = rec["counts"]
    train_k1 = c["K1"] - rec["eval_k1"]
    n = len(ROLLBACK_STEPS)
    log(f"rollback: launches K1 {c['K1']} ({train_k1} in {n} dispatches, {rec['eval_k1']} in {rec['eval_batches']} "
        f"eval batches), K2 {c['K2']}, K3 {c['K3']}")
    check(rec["eval_batches"] == 8 and rec["eval_k1"] == 32 * rec["eval_batches"],
          f"rollback: {rec['eval_batches']} eval batches (the sanity eval and steps 2, 4, 6), K1 {rec['eval_k1']}")
    check(train_k1 == 56 * n and c["K2"] == c["K3"] == 32 * n, "rollback: K1 56 and K2 = K3 32 per dispatch")

    # memory: a sample every window with the card's bytes, the leak named
    total = torch.cuda.get_device_properties(0).total_memory
    samples = [e for e in events if e["type"] == "mem_sample"]
    dev_bytes = [e.get("device_bytes", 0) for e in samples]
    check(len(samples) == n and all(0 < b < total for b in dev_bytes),
          f"rollback: {len(samples)} memory samples, device bytes {dev_bytes} (card {total})")
    rss = [e["rss_bytes"] for e in samples]
    log(f"rollback: host RSS MiB per sample {[r // 2**20 for r in rss]}, fault_ballast MiB "
        f"{[e['components'].get('fault_ballast', 0) // 2**20 for e in samples]}, device MiB "
        f"{[b // 2**20 for b in dev_bytes]}")
    leaks = [e for e in events if e["type"] == "mem_leak_suspect"]
    check(len(leaks) == 1 and leaks[0]["component"] == "fault_ballast",
          f"rollback: leak suspects {[(e['step'], e['component'], e['robust_growth_bytes']) for e in leaks]}")
    check(ballast == n * 16 * 2**20, f"rollback: the ballast held {ballast} bytes after {n} dispatches")
    rc = mem_doctor.main([str(run_dir), "--out", str(tmp / "mem.md")])
    report = (tmp / "mem.md").read_text()
    # the doctor's contract: exit 2 when a leak suspect was journaled
    check(rc == 2 and "leak suspected: **fault_ballast**" in report, f"rollback: mem_doctor exit {rc}")

    # the retrace sentinel: no unexpected dispatch signature after step 1
    check(retraces[0] == 0 and not [e for e in events if e["type"] == "retrace"],
          f"rollback: {retraces[0]} unexpected retraces")

    # the flight recorder: one dump for the bad window of steps 3-4, one for
    # the leak, one for the rollback, each holding the window it was dumped in
    records = [e for e in events if e["type"] == "flight_record"]
    reasons = sorted(e["reason"] for e in records)
    check(reasons == ["mem_leak", "nonfinite_step", "sentinel_rollback"], f"rollback: flight records {reasons}")
    want_last = {"nonfinite_step": 3, "sentinel_rollback": 4, "mem_leak": leaks[0]["step"]}
    for e in records:
        dump = json.loads(Path(e["path"]).read_text())
        last = dump["steps"][-1]["step"] if dump["steps"] else None
        check(dump["reason"] == e["reason"] and last == want_last[e["reason"]] and "written_at" in dump,
              f"rollback: the {e['reason']} dump ends at step {last}, want {want_last[e['reason']]}")
    nonfinite = json.loads(Path(next(e["path"] for e in records if e["reason"] == "nonfinite_step")).read_text())
    check(nonfinite["extra"]["bad_steps"] == [3], f"rollback: the first bad window {nonfinite['extra']}")
    res_diag = rollback_diagnostics(events, nonfinite, run_dir, tmp, run_doctor, perf_doctor, smi)

    # the goodput ledger: a report at each committed save and at shutdown
    reports = [e for e in events if e["type"] == "goodput_report"]
    final = reports[-1]
    check([(r["step"], r.get("reason")) for r in reports] == [(2, None), (4, None), (6, None), (6, "completed")],
          f"rollback: goodput reports {[(r['step'], r.get('reason')) for r in reports]}")
    check((final["steps"], final["recompute_steps"], final["conservation_error"]) == (5, 2, 0.0)
          and final["attributed_s"] <= final["wall_s"],
          f"rollback: the final goodput report {json.dumps(final)}")
    grc = goodput_doctor.main([str(run_dir), "--out", str(tmp / "goodput.md")])
    check(grc == 0, f"rollback: goodput_doctor exit {grc}")
    log(f"rollback: goodput at shutdown {final['goodput_fraction']:.4f} of {final['wall_s']:.3f} s, buckets "
        f"{json.dumps(final['buckets'])} (steps {final['steps']}, recompute {final['recompute_steps']}), on {smi}")

    # the exporter, scraped while the run was live
    health = seen["healthz"]
    check(seen["metrics"] is not None, f"rollback: no scrape of {seen['scrapes']} showed all of {WATCH_FAMILIES}")
    check(any(st == 200 and not d for st, d in health) and any(st == 200 and d is True for st, d in health),
          f"rollback: /healthz never answered 200 before and degraded after the leak: {sorted(set(health), key=str)}")
    hooks_us = watch_hooks_host_us()
    log(f"rollback: {seen['scrapes']} scrapes while live (median {np.median(seen['scrape_ms']):.2f} ms), /healthz "
        f"200 then degraded; the watch hooks {hooks_us:.2f} host µs a dispatch (spans, ledger, beats, gauges, "
        f"record_step, publish), on {smi}")
    res = dict(counts=c, eval_k1=rec["eval_k1"], losses=losses, rel=rel, bad_steps=bad, rollback=rb[0],
               leak=leaks[0], rss_mib=[r // 2**20 for r in rss], device_mib=[b // 2**20 for b in dev_bytes],
               retrace_compiles=retraces[1], mem_doctor_rc=rc, wall_s=rec["wall_s"], flight_records=reasons,
               goodput=final, goodput_doctor_rc=grc, scrapes=seen["scrapes"],
               scrape_ms=float(np.median(seen["scrape_ms"])), watch_hooks_us=hooks_us, diag=res_diag)
    res["seconds"] = time.perf_counter() - t0
    log(f"rollback: leak suspect {leaks[0]['component']} at step {leaks[0]['step']} "
        f"(+{leaks[0]['robust_growth_bytes'] // 2**20} MiB robust growth over {leaks[0]['window']} samples); "
        f"retrace 0 unexpected of {retraces[1]:.0f} dispatch signatures; main() {rec['wall_s']:.1f} s, phase 26 in "
        f"{res['seconds']:.1f} s, on {smi}")
    return res


# Phases 27 and 28: phase 13's recipe and shards again, without the sanity
# eval: 3 steps with the host spans and the device profile on (a log
# window a step, the final eval and its save), and, beside it in a child
# process, 4 steps with the hang watchdog and the third dispatch wedged
TRACE_SETS = ["run.epochs=0.375", "run.log_interval=1", "run.sanity_eval=false"]
TRACE_STEPS = 3
HANG_DEADLINE_S = 10.0
HANG_SETS = ["run.epochs=0.5", "run.sanity_eval=false", f"run.hangwatch_deadline_s={HANG_DEADLINE_S:g}",
             "run.faults=fleet.wedge:delay(600)@key~3,n<1"]
HANG_POLL_S = 1.0  # the watchdog's poll period (obs/hangwatch.py's default)
HANG_EXIT_SLACK_S = 5.0  # the drain, the dumps and the exit after a fired poll
# the kernels' names in a profile: substrings of each instantiation's name
PROFILE_NAMES = {"K1": "flash_fwd", "K2": "flash_bwd_dq", "K3": "flash_bwd_dkv"}


class _Tee:
    """stdout copied into a buffer (a run's printed lines, read after it)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def phase_traces(fa, smi: str, tmp: Path, driver: dict) -> dict:
    """Phase 27: ``run.chrome_trace`` and ``run.profile_dir`` through
    ``cli.train.main`` in this process on phase 13's recipe and shards, 3
    steps and the final eval and save: the chrome trace holds one
    ``data_wait`` and one ``train_step`` event a dispatch, and the
    ``torch.profiler`` trace names K1, K2 and K3 as many times as their
    launch counters counted over the run."""
    t0 = time.perf_counter()
    urls = driver["urls"]
    out = tmp / "traces"
    chrome, prof_dir = out / "chrome.json", out / "profile"
    sets = DRIVER_SETS + [f"data.train_shards={urls['train']}", f"data.valid_shards={urls['val']}",
                          f"run.output_dir={out}", *TRACE_SETS, f"run.chrome_trace={chrome}",
                          f"run.profile_dir={prof_dir}"]
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rec = run_driver(fa, ["--config", str(HERE / RECIPE), "--set", *sets])
    c = rec["counts"]
    n = len(rec["dispatch_s"])
    check(n == TRACE_STEPS and rec["eval_batches"] == 2, f"traces: {n} dispatches, {rec['eval_batches']} eval batches")
    check(c["K1"] == 56 * n + 32 * rec["eval_batches"] and c["K2"] == c["K3"] == 32 * n, f"traces: launches {c}")

    host = json.loads(chrome.read_text())["traceEvents"]
    names = {k: sum(1 for e in host if e["name"] == k) for k in ("data_wait", "train_step", "checkpoint_save")}
    check(names == {"data_wait": n, "train_step": n, "checkpoint_save": 1}, f"traces: chrome trace spans {names}")
    (path,) = prof_dir.glob("profile-*.json")
    line = next(x for x in "".join(tee.lines).splitlines() if x.startswith("[obs] device profile -> "))
    export_s = float(line.rsplit("exported in ", 1)[1].split(" s)")[0])
    t_parse = time.perf_counter()
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(1 for name in kernels if sub in name) for k, sub in PROFILE_NAMES.items()}
    t_parse = time.perf_counter() - t_parse
    log(f"traces: the profile names {found} against the launch counters {c} ({len(kernels)} kernels of "
        f"{len(events)} events; {path.stat().st_size} bytes exported in {export_s:.2f} s, read back in "
        f"{t_parse:.2f} s); the chrome trace {chrome.stat().st_size} bytes, spans {names}, on {smi}")
    check(found == c, f"traces: the profile names {found}, the launch counters say {c}")
    res = dict(counts=c, profile_counts=found, kernels=len(kernels), profile_bytes=path.stat().st_size,
               export_s=export_s, chrome_bytes=chrome.stat().st_size, spans=names, wall_s=rec["wall_s"])
    res["seconds"] = time.perf_counter() - t0
    log(f"traces: main() {rec['wall_s']:.1f} s, phase 27 in {res['seconds']:.1f} s, on {smi}")
    return res


def start_hang(tmp: Path, driver: dict) -> dict:
    """Phase 28, started: ``python -m jumbo_mae_tpu_tpu_torch.cli.train``
    in a session of its own on phase 13's recipe and shards, 4 steps, the
    hang watchdog at 10 s and the ``fleet.wedge`` site holding the third
    dispatch for 600 s; its output goes to a file."""
    urls = driver["urls"]
    out = tmp / "hang"
    out.mkdir(parents=True)
    sets = DRIVER_SETS + [f"data.train_shards={urls['train']}", f"data.valid_shards={urls['val']}",
                          f"run.output_dir={out}", *HANG_SETS]
    logf = open(out / "child.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "jumbo_mae_tpu_tpu_torch.cli.train", "--config", str(HERE / RECIPE),
                             "--set", *sets], cwd=HERE, stdout=logf, stderr=subprocess.STDOUT,
                            env={**os.environ, "PYTHONUNBUFFERED": "1"}, start_new_session=True)
    started = {"proc": proc, "log": logf, "out": out, "sets": sets, "t0": time.perf_counter(), "exit": {}}

    def stamp() -> None:  # the exit's time, however late the reaping
        proc.wait()
        started["exit"].update(time=time.time(), perf=time.perf_counter())

    started["stamp"] = threading.Thread(target=stamp, daemon=True)
    started["stamp"].start()
    return started


def finish_hang(smi: str, started: dict, timeout_s: float = 300.0) -> dict:
    """Phase 28, reaped: exit code 44 within the deadline, the poll and
    the drain's slack of the last step beat; ``hang_detected`` journaled
    with ``stalled_s`` >= 10, a final goodput report with ``reason:
    "hang"`` and ``hang_latency`` >= 10, a ``hang_detected`` flight record
    and ``[train] HANG`` on stdout. Its session goes with it (the loader's
    worker interpreters)."""
    import signal

    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal

    proc = started["proc"]
    try:
        rc = proc.wait(timeout=timeout_s)
        started["stamp"].join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        started["log"].close()
    t_exit = started["exit"]["time"]
    wall = started["exit"]["perf"] - started["t0"]
    text = (started["out"] / "child.log").read_text()
    if rc != 44:
        log(f"hang: the child exited {rc}; its output ends:\n{text[-3000:]}")
    check(rc == 44, f"hang: the child exited {rc}, want 44 (EXIT_HANG)")
    run_dir = started["out"] / load_config(HERE / RECIPE, started["sets"]).run.name
    events = read_journal(run_dir)
    hangs = [e for e in events if e["type"] == "hang_detected"]
    check(len(hangs) == 1 and hangs[0]["step"] == 3 and hangs[0]["stalled_s"] >= HANG_DEADLINE_S,
          f"hang: hang_detected rows {hangs}")
    hang = hangs[0]
    latency = t_exit - (hang["ts"] - hang["stalled_s"])  # from the last beat to the exit
    check(latency <= HANG_DEADLINE_S + HANG_POLL_S + HANG_EXIT_SLACK_S,
          f"hang: exit {latency:.2f} s after the last step beat")
    final = [e for e in events if e["type"] == "goodput_report"][-1]
    check(final.get("reason") == "hang" and final["buckets"]["hang_latency"] >= HANG_DEADLINE_S,
          f"hang: the final goodput report {json.dumps(final)}")
    dumps = list(run_dir.glob("flightrec-*-hang_detected.json"))
    check(len(dumps) == 1 and json.loads(dumps[0].read_text())["extra"]["step"] == 3,
          f"hang: hang_detected flight records {dumps}")
    check("[train] HANG: no step progress for" in text, "hang: no '[train] HANG' line on the child's stdout")
    res = dict(rc=rc, stalled_s=hang["stalled_s"], exit_after_beat_s=latency,
               hang_latency_s=final["buckets"]["hang_latency"], goodput=final["goodput_fraction"], wall_s=wall)
    log(f"hang: exit {rc} {latency:.2f} s after the last beat (stalled {hang['stalled_s']:.3f} s, deadline "
        f"{HANG_DEADLINE_S:g} s), goodput report {json.dumps(final['buckets'])}; the child's wall {wall:.1f} s, "
        f"on {smi}")
    return res


# ------------------------------------------- phase 29: a save's host copy and --distributed

# phase 13's recipe and shards in fresh processes, no sanity eval: (a) 6
# steps, a log window a step, a save every 2 steps, memwatch at its
# defaults (the leak sentinel's window and threshold under which phase 26's
# 16 MB a step is named), no fault plan; (b) two ranks on the one card,
# mesh.data=2 (64 rows each), 4 steps, saves at 2 and 4, the final eval,
# 2 workers a rank (each rank's stripe is 2 of the 4 train shards); (c) one
# process evaluating (b)'s step-4 save
C10_SETS = ["run.log_interval=1", "run.ckpt_every=2", "run.sanity_eval=false"]
DIST_SETS = ["run.epochs=0.5", "run.log_interval=1", "run.ckpt_every=2", "run.sanity_eval=false", "mesh.data=2",
             "data.workers=2"]
DIST_STEPS = 4
EVAL_ONLY_SETS = ["run.eval_only=true", "run.resume=true", "run.sanity_eval=false"]
EVAL_RTOL = 1e-3  # (c) against (b): other rows per batch, so other mask draws
PHASE29_MARK = "[phase29] "
PHASE29_CODE = ("import json, sys, chip_smoke\n"
                "res = chip_smoke.phase29_child(json.loads(sys.argv[1]))\n"
                "print(chip_smoke.PHASE29_MARK + json.dumps(res), flush=True)\n")


def _state_digest(state) -> str:
    """A digest of every byte of the model's state dict."""
    import hashlib

    import torch

    h = hashlib.sha1()
    for k, v in sorted(state.model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def phase29_child(spec: dict) -> dict:
    """One process of phase 29: ``cli.train.main(spec["argv"])`` through
    :func:`run_driver` (the launch counts set to 0 just before, read just
    after), with the resident set after each save, the device-synchronized
    seconds of each gradient all-reduce over the ``data`` group (with its
    staging through the host under gloo) and a digest of the final
    parameters."""
    import torch

    from jumbo_mae_tpu_tpu_torch.cli import train as cli
    from jumbo_mae_tpu_tpu_torch.obs.memwatch import host_rss_bytes
    from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa
    from jumbo_mae_tpu_tpu_torch.train import steps
    from jumbo_mae_tpu_tpu_torch.train.checkpoint import Checkpointer

    out = {"save_rss": [], "reduce_s": []}
    final = {}
    save, average, engine_cls = Checkpointer.save, steps._average_over_data, cli.RunEngine

    def save_rss(self, step, state, metrics=None, extra=None):
        r = save(self, step, state, metrics=metrics, extra=extra)
        out["save_rss"].append({"step": step, "rss_bytes": host_rss_bytes(),
                                "host_copy_bytes": self.host_copy_bytes()})
        return r

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def timed_average(*args):
        sync()
        t0 = time.perf_counter()
        r = average(*args)
        sync()
        out["reduce_s"].append(time.perf_counter() - t0)
        return r

    class Kept(engine_cls):
        def run(self, state):
            try:
                return super().run(state)
            finally:
                final["state"] = self.state

    Checkpointer.save, steps._average_over_data, cli.RunEngine = save_rss, timed_average, Kept
    try:
        # no batch kept: 18.4 MiB a step held by the recorder would read as a leak
        rec = run_driver(fa, spec["argv"], keep_images=False)
    finally:
        Checkpointer.save, steps._average_over_data, cli.RunEngine = save, average, engine_cls
    out.update(counts=rec["counts"], eval_k1=rec["eval_k1"], eval_batches=rec["eval_batches"],
               losses=[m["loss"] for m in rec["metrics"]], evals=rec["evals"], wall_s=rec["wall_s"],
               dispatch_s=rec["dispatch_s"], rss_end_bytes=host_rss_bytes())
    if "state" in final:
        out["digest"] = _state_digest(final["state"])
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase29_children(argvs: list[list[str]], logs: list[Path], timeout_s: float = 600.0) -> list[dict]:
    """Run :func:`phase29_child` in one fresh process per argv, all at
    once, to their ends: their results. Output goes to files (ranks in a
    collective must never block on a full pipe); when one fails, the
    others are killed, not waited out, and the phase fails with the end of
    its log."""
    procs = []
    for argv, path in zip(argvs, logs):
        f = open(path, "w")
        procs.append((subprocess.Popen([sys.executable, "-c", PHASE29_CODE, json.dumps({"argv": argv})], cwd=HERE,
                                       stdout=f, stderr=subprocess.STDOUT, env={**os.environ, "PYTHONUNBUFFERED": "1"}),
                      f))
        LIVE_CHILDREN.add(procs[-1][0])
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p, _ in procs):
            if any(p.poll() not in (None, 0) for p, _ in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            f.close()
            LIVE_CHILDREN.discard(p)
    res = []
    for (p, _), path in zip(procs, logs):
        text = path.read_text()
        if p.returncode != 0:
            log(f"phase 29: a child exited {p.returncode}; its output ends:\n{text[-4000:]}")
        check(p.returncode == 0, f"phase 29: the child of {path.name} exited {p.returncode}")
        line = [x for x in text.splitlines() if x.startswith(PHASE29_MARK)][-1]
        res.append({**json.loads(line[len(PHASE29_MARK):]), "log": text})
    return res


def _check_launches(what: str, rec: dict, steps: int, eval_batches: int) -> None:
    c = rec["counts"]
    check(rec["eval_batches"] == eval_batches and rec["eval_k1"] == 32 * eval_batches,
          f"{what}: {rec['eval_batches']} eval batches, {rec['eval_k1']} eval K1 launches (want {eval_batches} and "
          f"{32 * eval_batches})")
    check(c["K1"] - rec["eval_k1"] == 56 * steps and c["K2"] == c["K3"] == 32 * steps,
          f"{what}: launches {c} over {steps} steps (want K1 56 and K2 = K3 32 a step)")


def phase_distributed(smi: str, tmp: Path, driver: dict) -> dict:
    """Phase 29 alone, its legs one after the other: (a) from
    :func:`phase29_c10`, then (b) and (c) from :func:`phase29_dist`."""
    t0 = time.perf_counter()
    res = {"c10": phase29_c10(smi, tmp, driver), **phase29_dist(smi, tmp, driver)}
    res["seconds"] = time.perf_counter() - t0
    log(f"distributed: phase 29 in {res['seconds']:.1f} s, on {smi}")
    return res


def _phase29_base(driver: dict) -> tuple[list[str], str]:
    from jumbo_mae_tpu_tpu_torch.config import load_config

    urls = driver["urls"]
    base = ["--config", str(HERE / RECIPE), "--set", *DRIVER_SETS, f"data.train_shards={urls['train']}",
            f"data.valid_shards={urls['val']}"]
    return base, load_config(HERE / RECIPE, []).run.name


def phase29_c10(smi: str, tmp: Path, driver: dict) -> dict:
    """Phase 29 (a), C10's gate: phase 13's run alone in a fresh process
    with saves at steps 2, 4 and 6 and the leak sentinel at its defaults:
    no ``mem_leak_suspect``, the save's host copy named ``ckpt_host_copy``
    from the first memory sample on, the resident set after each save. It
    runs only a child process (:class:`Background` can run it beside
    other phases): the sentinel reads that process's own resident set."""
    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal

    t0 = time.perf_counter()
    base, name = _phase29_base(driver)
    out_a = tmp / "c10"
    (a,) = phase29_children([base + [f"run.output_dir={out_a}", *C10_SETS]], [tmp / "c10.log"])
    _check_launches("c10", a, DRIVER_STEPS, 2)
    events = read_journal(out_a / name)
    samples = [e for e in events if e["type"] == "mem_sample"]
    leaks = [e for e in events if e["type"] == "mem_leak_suspect"]
    copies = {e["components"].get("ckpt_host_copy") for e in samples}
    rss = [e["rss_bytes"] for e in samples]
    log(f"c10: RSS GB at each sample {[round(x / 2**30, 3) for x in rss]}; after each save "
        f"{[(s['step'], round(s['rss_bytes'] / 2**30, 3)) for s in a['save_rss']]}; ckpt_host_copy "
        f"{sorted(c / 2**30 for c in copies if c)} GB; leak suspects {leaks}; on {smi}")
    check(len(samples) == DRIVER_STEPS and len(copies) == 1 and (next(iter(copies)) or 0) > 2**30,
          f"c10: {len(samples)} memory samples, ckpt_host_copy {copies}")
    check(not leaks, f"c10: the leak sentinel fired without a leak: {leaks}")
    check([s["step"] for s in a["save_rss"]] == [2, 4, 6], f"c10: saves {a['save_rss']}")
    res = dict(rss_gb=[x / 2**30 for x in rss], save_rss_gb=[s["rss_bytes"] / 2**30 for s in a["save_rss"]],
               host_copy_gb=next(iter(copies)) / 2**30, growth_gb=(max(rss) - rss[0]) / 2**30,
               wall_s=a["wall_s"])
    shutil.rmtree(out_a)
    res["seconds"] = time.perf_counter() - t0
    log(f"c10: phase 29 (a) in {res['seconds']:.1f} s, on {smi}")
    return res


def phase29_dist(smi: str, tmp: Path, driver: dict) -> dict:
    """Phase 29 (b) and (c): ``--distributed`` on two ranks sharing the
    card over gloo (the backend rule's choice, printed), ``mesh.data=2``:
    launches per rank, finite losses equal on both, the final parameters
    bit-equal, process 0's saves committed with both cursors, both
    journals' ``shard_cursor`` rows at ``world: 2``, one ``val/loss``
    though rank 1's stripe of the one valid shard is empty; the gradient
    all-reduce's share of a step; then one process evaluating (b)'s
    step-4 save (``run.eval_only``) within 1e-3 relative of (b)'s final
    eval. Only child processes, as :func:`phase29_c10`."""
    import numpy as np

    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal

    t0 = time.perf_counter()
    base, name = _phase29_base(driver)
    res: dict = {}

    # (b) two ranks on the one card
    out_b = tmp / "dist"
    port = _free_port()
    argvs = [base + [f"run.output_dir={out_b}", *DIST_SETS, "--distributed", "--coordinator", f"127.0.0.1:{port}",
                     "--num-processes", "2", "--process-id", str(r)] for r in (0, 1)]
    t_b = time.perf_counter()
    ranks = phase29_children(argvs, [tmp / "dist0.log", tmp / "dist1.log"])
    t_b = time.perf_counter() - t_b
    starts = [next(x for x in r["log"].splitlines() if x.startswith("[train] --distributed:")) for r in ranks]
    log(f"dist: {starts[0]} | {starts[1]}")
    check(all("backend gloo (more processes than cards" in s for s in starts), f"dist: backends {starts}")
    for r, rec in enumerate(ranks):
        _check_launches(f"dist rank {r}", rec, DIST_STEPS, 4 if r == 0 else 0)
    losses = [rec["losses"] for rec in ranks]
    check(len(losses[0]) == DIST_STEPS and all(np.isfinite(losses[0])) and losses[0] == losses[1],
          f"dist: losses {losses}")
    check(ranks[0]["digest"] == ranks[1]["digest"], f"dist: parameter digests {[r['digest'] for r in ranks]}")
    vals = [rec["evals"][-1]["val/loss"] for rec in ranks]
    check(vals[0] == vals[1] and np.isfinite(vals[0]), f"dist: val/loss {vals}")
    run_b = out_b / name
    for step in (2, 4):
        d = run_b / "ckpt" / "last" / str(step)
        cur = json.loads((d / "extra.json").read_text())["data_cursor"]
        check((d / "COMMIT").exists() and cur["process_count"] == 2 and len(cur["per_process"]) == 2,
              f"dist: save {step}: committed {(d / 'COMMIT').exists()}, cursor {cur}")
    for journal in ("journal", "journal-host1"):
        rows = [(e["step"], e["world"]) for e in read_journal(run_b / journal) if e["type"] == "shard_cursor"]
        check(rows == [(2, 2), (4, 2)], f"dist: {journal}'s shard_cursor rows {rows}")
    step_ms = [1e3 * float(np.mean(rec["dispatch_s"][1:])) for rec in ranks]
    reduce_ms = [1e3 * float(np.mean(rec["reduce_s"][1:])) for rec in ranks]
    share = [r / s for r, s in zip(reduce_ms, step_ms)]
    log(f"dist: losses {losses[0]}, val/loss {vals[0]}, digest {ranks[0]['digest']}; steps 2-{DIST_STEPS}: the "
        f"dispatch {step_ms[0]:.1f} / {step_ms[1]:.1f} ms (rank 0 / 1), the gradient all-reduce with its host staging "
        f"{reduce_ms[0]:.1f} / {reduce_ms[1]:.1f} ms ({100 * share[0]:.1f} / {100 * share[1]:.1f} % of it; two ranks "
        f"on one card, not a scaling figure); launches {[r['counts'] for r in ranks]}; (b) in {t_b:.1f} s; on {smi}")
    res["dist"] = dict(losses=losses[0], val_loss=vals[0], step_ms=step_ms, reduce_ms=reduce_ms, reduce_share=share,
                       counts=[r["counts"] for r in ranks], wall_s=t_b)

    # (c) the save under one process
    (c,) = phase29_children([base + [f"run.output_dir={out_b}", *EVAL_ONLY_SETS]], [tmp / "eval_only.log"])
    check(c["eval_batches"] == 2 and c["eval_k1"] == c["counts"]["K1"] == 64,
          f"eval_only: {c['eval_batches']} batches, launches {c['counts']}")
    val_c = c["evals"][-1]["val/loss"]
    rel = abs(val_c - vals[0]) / abs(vals[0])
    log(f"eval_only: one process on (b)'s step-4 save val/loss {val_c} against (b)'s {vals[0]}: relative "
        f"difference {rel:.3e} (limit {EVAL_RTOL:g}); on {smi}")
    check(rel <= EVAL_RTOL, f"eval_only: val/loss {val_c} against {vals[0]}, relative {rel:.3e}")
    res["eval_only"] = dict(val_loss=val_c, rel_diff=rel)
    shutil.rmtree(out_b)
    res["seconds"] = time.perf_counter() - t0
    log(f"distributed: phase 29 (b) and (c) in {res['seconds']:.1f} s, on {smi}")
    return res


def main() -> None:
    import gc

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("[chip_smoke] FAIL: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    try:
        from jumbo_mae_tpu_tpu_torch.ops import _build
        from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa
    except ImportError as exc:
        raise SystemExit(f"[chip_smoke] FAIL: the port is not importable here: {exc}") from exc

    # the serving warm cache stays off in this process and the batch jobs'
    # children: phase 21 points its probes at directories of its own
    os.environ["JUMBO_WARMCACHE"] = "0"
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # phase 13's shards are written by a child process beside phases 2-12
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_driver_"))
    try:
        shards = start_shards(tmp)
        build_kernels(_build)

        errs = phase_kernels(fa)
        bwd_errs = phase_bwd_kernels(fa)
        k1_timings = phase_timings(fa)
        bwd_timings = phase_bwd_timings(fa, k1_timings)
        serve_launches, dispatches = phase_slice(fa, smi, FT_RECIPE, "cuda")
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
        driver = phase_driver(fa, smi, tmp, train["step_ms"], shards)
        resume = phase_resume(fa, smi, tmp, driver)
        # phase 29 runs only child processes on phase 13's shards: (a) beside
        # phases 15-17, (b) and (c) beside phases 21-22 (not beside the
        # serving phases 19-20 and 23-24, whose gates ride on timing, or
        # whose ballast fills the card); the card's memory this process
        # keeps cached goes back first
        gc.collect()
        torch.cuda.empty_cache()
        c10_run = Background(phase29_c10, smi, tmp, driver)
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
        c10 = c10_run.join()
        t4b = time.perf_counter()
        # the saves of phases 13, 16 and 17, served before their directory goes
        served = phase_serve_saves(fa, smi, tmp, driver["urls"])
        t5 = time.perf_counter()
        replicated = phase_replicated(fa, smi, tmp, driver["urls"])
        t6 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        dist_run = Background(phase29_dist, smi, tmp, driver)
        warm = phase_warm_restart(smi, tmp)
        t7 = time.perf_counter()
        batch = phase_batch_job(smi, tmp, driver["urls"])
        t8 = time.perf_counter()
        dist = dist_run.join()
        t8b = time.perf_counter()
        distributed = {"c10": c10, **dist}
        billing = phase_billing(fa, smi, tmp, driver["urls"], train["step_ms"])
        t9 = time.perf_counter()
        telemetry = phase_telemetry(fa, smi, tmp)
        t10 = time.perf_counter()
        h14 = phase_h14(fa, smi, tmp, driver["urls"])
        t11 = time.perf_counter()
        # phase 18's two children run beside phases 26-28 (after phase 25's
        # kernel timings): their gates are exit codes and accuracies, not
        # speeds, and each is a process of its own with PyTorch's defaults
        toy_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_toy_"))
        toy_run = start_toy_proof(toy_tmp)
        try:
            # the earlier phases' cyclic garbage (engines, memory-mapped saves)
            # goes now: collected inside phase 26's run, its freed gigabytes land
            # in the leak sentinel's RSS window (a 7-GB drop at the third sample
            # in a run without this). Phase 26 reads only phase 13's shards: the
            # earlier phases' saves (tens of GB) go too, so that its own saves
            # can take their blocks; the card's machine caps what one call
            # writes to its disk
            gc.collect()
            used = shutil.disk_usage(tmp).used
            for child in tmp.iterdir():
                if child.name != "shards":
                    shutil.rmtree(child) if child.is_dir() else child.unlink()
            log(f"disk: {used / 2**30:.1f} GiB used after phase 25, {shutil.disk_usage(tmp).used / 2**30:.1f} GiB "
                "with only phase 13's shards kept")
            # phase 28's child runs beside phases 26-27: its gates are an
            # exit code, its own step beats and a journal, not speeds
            hang_run = start_hang(tmp, driver)
            try:
                rollback = phase_rollback(fa, smi, tmp, driver)
                log(f"disk: {shutil.disk_usage(tmp).used / 2**30:.1f} GiB used after phase 26")
                t12 = time.perf_counter()
                shutil.rmtree(tmp / "rollback")
                traces = phase_traces(fa, smi, tmp, driver)
            finally:
                hang = finish_hang(smi, hang_run)
            t13 = time.perf_counter()
        finally:
            try:
                toy = finish_toy_proof(smi, toy_run)
            finally:
                shutil.rmtree(toy_tmp, ignore_errors=True)
        t14 = time.perf_counter()
        log(f"seconds: phase 15 {t1 - t0:.1f}, phase 16 {t2 - t1:.1f}, its f32 step {t3 - t2:.1f}, phase 17 "
            f"{t4 - t3:.1f}, then waited {t4b - t4:.1f} for phase 29 (a) (beside phases 15-17, {c10_run.seconds:.1f} "
            f"s), phase 19 {t5 - t4b:.1f}, phase 20 {t6 - t5:.1f}, phase 21 {t7 - t6:.1f}, phase 22 {t8 - t7:.1f}, "
            f"then waited {t8b - t8:.1f} for phase 29 (b) and (c) (beside phases 21-22, {dist_run.seconds:.1f} s), "
            f"phase 23 {t9 - t8b:.1f}, phase 24 {t10 - t9:.1f}, phase 25 {t11 - t10:.1f}, phase 26 {t12 - t11:.1f}, "
            f"phase 27 {t13 - t12:.1f} (in it {traces['seconds']:.1f}; phase 28's child beside phases 26-27 "
            f"{hang['wall_s']:.1f}), then waited {t14 - t13:.1f} for phase 18's children (beside phases 26-28, "
            f"{toy['seconds']:.1f} s); phases 1-14 took {t0 - t_start:.1f}")
    finally:
        kill_children()
        shutil.rmtree(tmp, ignore_errors=True)
    keys = ("step_ms", "images_per_s", "mfu", "data_wait_s_per_step", "loader_wait_s", "dispatch_s", "save_s", "write_s",
            "save_bytes")
    summary = {"backends": backends, **{k: driver[k] for k in keys}, "phase7_step_ms": train["step_ms"],
               "resume": resume}
    log(f"cli/train.py: {json.dumps(summary)} on {smi}")
    classify = {"finetune": {k: v for k, v in finetune.items() if k != "counts"},
                "linear": {k: v for k, v in linear.items() if k != "counts"}, "toy_proof": toy}
    log(f"classify paths: {json.dumps(classify)} on {smi}")
    log(f"serving from the saves: {json.dumps({k: v for k, v in served.items() if k != 'buckets'})} on {smi}")
    log(f"the replicated serving tier: {json.dumps(replicated)} on {smi}")
    log(f"warm restarts: {json.dumps(warm)} on {smi}")
    log(f"batch jobs: {json.dumps(batch)} on {smi}")
    log(f"billing, autoscaling and publishing: {json.dumps(billing)} on {smi}")
    log(f"serving telemetry and health: {json.dumps(telemetry)} on {smi}")
    log(f"the step's diagnostics (phase 7b): {json.dumps(train['diag'])} on {smi}")
    log(f"ViT-H/14 from its recipe: {json.dumps(h14_summary(h14))} on {smi}")
    log(f"the run's safety layers: {json.dumps(rollback)} on {smi}")
    log(f"the run's traces: {json.dumps(traces)} on {smi}")
    log(f"the hang: {json.dumps(hang)} on {smi}")
    log(f"a save's host copy and --distributed: {json.dumps(distributed)} on {smi}")

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
            **({"serve_launches": served["serve_launches"], "replicated_launches": replicated["k1"],
                "warm_launches": warm["k1"], "batch_launches": batch["k1"], "billing_launches": billing["k1"],
                "telemetry_launches": telemetry["k1"]}
               if key == "K1" else {}),
            "publish_launches": billing["publish"][key.lower()],
            "h14_launches": h14["run"]["counts"][key],
            "rollback_launches": rollback["counts"][key],
            "trace_launches": traces["counts"][key],
            "trace_profile_kernels": traces["profile_counts"][key],
            **h14_kernel_fields(h14, key),
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
        "publish_launches": billing["publish"]["k2"],
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
