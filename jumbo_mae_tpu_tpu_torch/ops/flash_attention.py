"""Attention over (batch, seq, heads, head_dim) tensors with q pre-scaled.

Counterpart of ``jumbo_mae_tpu_tpu/ops/flash_attention.py``:

- :func:`flash_attention` is differentiable: a ``torch.autograd.Function``
  whose forward is the hand-written CUDA kernel K1 (saving o and lse) and
  whose backward runs K2 (which computes D = rowsum(dO ∘ O) for its
  rows) then K3 (``ops/flash/attention.py``) — the counterpart of the JAX package's
  ``pallas_flash_attention`` custom_vjp. On CPU tensors the same Function
  runs the plain forward and the plain backward;
- :func:`flash_attention_with_lse` is K4, the counterpart of
  ``pallas_flash_attention_with_lse``: ``(o, lse)`` differentiable in
  both, the lse cotangent folded into K2's D as ``D − g_lse``. Ring
  attention's flash hops merge in lse space through it;
- :func:`einsum_attention` is the counterpart of ``xla_attention``:
  float32 scores and softmax, probabilities cast to v's dtype.
"""

from __future__ import annotations

import torch

from jumbo_mae_tpu_tpu_torch.ops.flash.attention import (
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_with_lse_fwd,
    lse_cotangents,
)


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class FlashAttention(torch.autograd.Function):
    """softmax(q·kᵀ)·v with the flash kernels on both passes. Saves
    (q, k, v, o, lse): O(seq) memory, the score matrix is recomputed."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ)·v without materializing the score matrix on the GPU.

    q, k, v: (batch, seq, heads, head_dim). Returns the shape of q. When a
    gradient is wanted it goes through :class:`FlashAttention`; otherwise
    the forward kernel runs alone, without writing lse."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    return flash_attention_fwd(q, k, v)


class FlashAttentionWithLse(torch.autograd.Function):
    """(o, lse) with the flash kernels: K1 writing lse forward; K2 (which
    computes D = rowsum(dO ∘ O) − g_lse) then K3 backward. An unused
    output's cotangent arrives as ``None`` (materialization off) and counts
    as zero."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.set_materialize_grads(False)
        o, lse = flash_attention_with_lse_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        if g_o is None and g_lse is None:
            return None, None, None
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, lse_cotangents(o, g_o), g_lse=g_lse)


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: o = softmax(q·kᵀ)·v in q's shape and dtype, lse the
    float32 log-sum-exp of each query row's scores as (batch·heads, seq_q),
    row ``b·heads + h`` (the JAX layout). Differentiable in both outputs."""
    return FlashAttentionWithLse.apply(q, k, v)
