"""Blockwise (memory-efficient) attention in plain PyTorch.

Counterpart of ``jumbo_mae_tpu_tpu/ops/blockwise_attention.py``: an online
softmax over chunks of the key axis, with float32 running max ``m``, sum
``l`` and accumulator ``acc``, so no (seq_q, seq_k) score matrix of the
whole sequence is ever held. Each chunk runs under
``torch.utils.checkpoint`` (non-reentrant), as the JAX chunk runs under
``jax.checkpoint``: the backward recomputes a chunk's scores instead of
saving them, which keeps its memory O(seq) too.

Inputs are (batch, seq, heads, head_dim), queries pre-scaled. The JAX
module is XLA, not Pallas, so this is plain PyTorch on every device; the
port's :func:`~jumbo_mae_tpu_tpu_torch.ops.flash_attention.flash_attention`
takes it off CUDA from 2,048 tokens, as the JAX one does off the TPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _chunk(q, kb, vb, bias, m, l, acc, valid: int):
    """One key chunk of the online softmax: scores in float32, the pad keys
    past ``valid`` at NEG_INF, then (m, l, acc) rescaled and updated."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float())
    if bias is not None:
        s = s + bias
    if valid < kb.shape[1]:
        pad = torch.arange(kb.shape[1], device=s.device) >= valid
        s = s.masked_fill(pad, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha.permute(0, 2, 1, 3) + torch.einsum("bhqk,bkhd->bqhd", p.to(vb.dtype).float(), vb.float())
    return m_new, l, acc


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_k: int = 512,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """softmax(q·kᵀ + bias)·v without the full score matrix.

    ``bias`` (optional) broadcasts to (batch, heads, seq_q, seq_k) and is
    sliced along the key axis per chunk. The last chunk is padded; its pad
    keys score NEG_INF (a bias over the keys is padded with NEG_INF too).
    Returns the shape and dtype of q."""
    seq_k = k.shape[1]
    block_k = min(block_k, seq_k)
    num_blocks = -(-seq_k // block_k)
    pad = num_blocks * block_k - seq_k
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if bias is not None and bias.shape[-1] == seq_k:
            bias = F.pad(bias, (0, pad), value=NEG_INF)
    b, sq, h, d = q.shape
    if bias is not None:
        bias = bias.expand(b, h, sq, seq_k + pad)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    grad = torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (q, k, v, bias)
    )
    for i in range(num_blocks):
        cols = slice(i * block_k, (i + 1) * block_k)
        args = (q, k[:, cols], v[:, cols], None if bias is None else bias[..., cols], m, l, acc,
                min(block_k, seq_k - i * block_k))
        m, l, acc = checkpoint(_chunk, *args, use_reentrant=False) if grad else _chunk(*args)
    return (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
