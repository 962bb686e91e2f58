"""Worker processes of tests/test_torch_gloo.py: the port under a real
``torch.distributed`` process group (gloo, on the CPU).

    python tests/torch_gloo_workers.py JOB RANK WORLD STORE OUT

joins a gloo group of ``WORLD`` processes through the ``FileStore`` at
``STORE`` (no network address), runs ``JOB`` and ``torch.save``s its
results to ``OUT``. The jobs, and the one-process runs they are held
against, are the functions below.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.parallel import MeshConfig, create_mesh, ring_self_attention, set_mesh
from jumbo_mae_tpu_tpu_torch.train import optim as topt
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step

# (inner, sequence length): even splits for both inners, an uneven one
# (padded and masked) for the einsum inner
RING_CASES = (("einsum", 16), ("flash", 16), ("einsum", 19))
SIZE = 32
GLOBAL_BATCH = 8
STEPS = 2
DROPOUT = 0.1  # the data_dropout job's rate
OPT = topt.OptimConfig(learning_rate=1e-3, lr_scaling="none", warmup_steps=1, training_steps=10, weight_decay=0.05)


def ring_inputs(s: int):
    """q, k, v (global, the same on every rank) and the output cotangent."""
    rng = np.random.default_rng(s)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((2, s, 4, 8)).astype(np.float32)) for _ in range(4))
    return q * 8**-0.5, k, v, w


def ring_results(mesh) -> dict:
    """Each case's output and the gradients of ``(out · w).sum()``."""
    out = {}
    for inner, s in RING_CASES:
        q, k, v, w = ring_inputs(s)
        xs = [x.requires_grad_() for x in (q, k, v)]
        o = ring_self_attention(*xs, mesh=mesh, inner=inner)
        (o * w).sum().backward()
        out[(inner, s)] = [o.detach()] + [x.grad for x in xs]
    return out


def mae_state(dropout: float = 0.0):
    """A tiny MAE state with DropPath and per-sample masking, so both draw
    per sample of the global batch; with ``dropout``, every dropout site
    of the encoder and decoder (the einsum path) draws per entry of it."""
    enc = preset("vit_t16", labels=None, mask_ratio=0.75, image_size=SIZE, patch_size=8, posemb="sincos2d",
                 dtype="float32", droppath=0.25, mask_mode="per_sample", dropout=dropout, attn_impl="einsum")
    dec = DecoderConfig(layers=1, dim=32, heads=2, dtype="float32", dropout=dropout, attn_impl="einsum")
    return create_state((enc, dec, True), OPT, device="cpu", init_seed=3, rng_seed=4, global_batch_size=256)


def step_results(shard: tuple[int, int], dropout: float = 0.0) -> dict:
    """Losses and parameters after ``STEPS`` steps on this rank's rows."""
    state, step = mae_state(dropout), make_train_step()
    batches = synthetic_batches(GLOBAL_BATCH, SIZE, seed=5, shard=shard)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, next(batches))
        losses.append(m["loss"].item())
    return {"loss": losses, "params": {n: p.detach().clone() for n, p in state.model.named_parameters()}}


def main(job: str, rank: int, world: int, store: str, out: str) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        if job == "ring":
            res = ring_results(create_mesh(MeshConfig(data=1, fsdp=1, seq=world), device="cpu"))
        elif job in ("data", "data_dropout"):
            mesh = create_mesh(MeshConfig(data=world), device="cpu")
            with set_mesh(mesh):
                res = step_results((mesh.data_rank, world), DROPOUT if job == "data_dropout" else 0.0)
        else:
            raise ValueError(f"unknown job {job!r}")
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
