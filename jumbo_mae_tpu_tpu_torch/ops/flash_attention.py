"""Attention over (batch, seq, heads, head_dim) tensors with q pre-scaled.

Counterpart of ``jumbo_mae_tpu_tpu/ops/flash_attention.py``:

- :func:`flash_attention` runs the hand-written CUDA forward kernel
  (``ops/flash/attention.py``) on CUDA tensors, its plain version on CPU
  tensors;
- :func:`einsum_attention` is the counterpart of ``xla_attention``:
  float32 scores and softmax, probabilities cast to v's dtype.
"""

from __future__ import annotations

import torch

from jumbo_mae_tpu_tpu_torch.ops.flash.attention import flash_attention_fwd


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ)·v without materializing the score matrix on the GPU.

    q, k, v: (batch, seq, heads, head_dim). Returns the shape of q."""
    return flash_attention_fwd(q, k, v)
