"""The port's blockwise attention against the JAX package's, on the CPU.

``ops/blockwise_attention.py`` (an online softmax over key chunks, each
chunk recomputed in the backward) on the same seeded numpy inputs as
``jumbo_mae_tpu_tpu/ops/blockwise_attention.py``: forward and the
gradients of q, k, v and the bias, with and without a bias, with key
counts that do and do not divide into chunks (the last chunk padded).
float32 at atol/rtol 1e-5: the same online softmax, summed in another
order. Then the port's ``flash_attention`` on CPU tensors from 2,048
tokens (the blockwise path) against the JAX ``flash_attention`` off the
TPU, which takes the same path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.ops.blockwise_attention import blockwise_attention as jax_blockwise
from jumbo_mae_tpu_tpu.ops.flash_attention import flash_attention as jax_flash
from jumbo_mae_tpu_tpu_torch.ops import flash_attention as tfa
from jumbo_mae_tpu_tpu_torch.ops.blockwise_attention import blockwise_attention
from jumbo_mae_tpu_tpu_torch.ops.flash_attention import einsum_attention, flash_attention

TOL = dict(atol=1e-5, rtol=1e-5)


def inputs(b, sq, sk, h, d, bias_shape, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32) * d**-0.5
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    bias = None if bias_shape is None else rng.standard_normal(bias_shape).astype(np.float32)
    return q, k, v, bias, do


def jax_grads(fn, q, k, v, bias, do):
    args = [jnp.asarray(x) for x in (q, k, v)] + ([] if bias is None else [jnp.asarray(bias)])

    def loss(*a):
        return jnp.sum(fn(*a) * jnp.asarray(do))

    out = fn(*args)
    return np.asarray(out), [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(len(args))))(*args)]


def torch_grads(fn, q, k, v, bias, do):
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    if bias is not None:
        args.append(torch.from_numpy(bias).requires_grad_())
    out = fn(*args)
    grads = torch.autograd.grad(out, args, torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


# (seq_k, block_k): chunks that divide the keys, and a padded last chunk
SEQS = [(256, 64), (300, 128)]
BIASES = [None, "full", "keys"]


@pytest.mark.parametrize("bias_kind", BIASES)
@pytest.mark.parametrize("seq_k,block_k", SEQS)
def test_blockwise_matches_jax(seq_k, block_k, bias_kind):
    b, sq, h, d = 2, 70, 3, 16
    shape = {None: None, "full": (b, h, sq, seq_k), "keys": (b, 1, 1, seq_k)}[bias_kind]
    q, k, v, bias, do = inputs(b, sq, seq_k, h, d, shape, seed=seq_k + len(str(bias_kind)))
    if bias is None:
        jfn = lambda q, k, v: jax_blockwise(q, k, v, block_k=block_k)  # noqa: E731
        tfn = lambda q, k, v: blockwise_attention(q, k, v, block_k=block_k)  # noqa: E731
    else:
        jfn = lambda q, k, v, bb: jax_blockwise(q, k, v, block_k=block_k, bias=bb)  # noqa: E731
        tfn = lambda q, k, v, bb: blockwise_attention(q, k, v, block_k=block_k, bias=bb)  # noqa: E731
    ref_o, ref_g = jax_grads(jfn, q, k, v, bias, do)
    got_o, got_g = torch_grads(tfn, q, k, v, bias, do)
    np.testing.assert_allclose(got_o, ref_o, **TOL)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got_g, ref_g):
        np.testing.assert_allclose(g, r, **TOL, err_msg=name)


def test_blockwise_equals_full_attention():
    """Without a bias, the online softmax is softmax(q·kᵀ)·v (the einsum
    path on the same inputs)."""
    q, k, v, _, _ = inputs(1, 33, 190, 2, 16, None, seed=5)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    torch.testing.assert_close(blockwise_attention(*t, block_k=64), einsum_attention(*t), **TOL)


@pytest.mark.parametrize("seq", [2048, 2100])
def test_cpu_flash_attention_from_2048_tokens_matches_jax(seq, monkeypatch):
    """The port's flash_attention on CPU tensors takes the blockwise path
    from 2,048 tokens (key chunks of 1,024), as the JAX flash_attention off
    the TPU does: forward and gradients equal the JAX function's."""
    calls = []
    real = tfa.blockwise_attention
    monkeypatch.setattr(tfa, "blockwise_attention", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    q, k, v, _, do = inputs(1, seq, seq, 2, 16, None, seed=seq)
    ref_o, ref_g = jax_grads(jax_flash, q, k, v, None, do)
    got_o, got_g = torch_grads(flash_attention, q, k, v, None, do)
    assert calls == [{"block_k": 1024}]
    np.testing.assert_allclose(got_o, ref_o, **TOL)
    for name, g, r in zip(("dq", "dk", "dv"), got_g, ref_g):
        np.testing.assert_allclose(g, r, **TOL, err_msg=name)


def test_cpu_flash_attention_below_2048_tokens_is_unchanged(monkeypatch):
    """Below 2,048 tokens the CPU path stays the plain flash forward."""
    monkeypatch.setattr(tfa, "blockwise_attention", lambda *a, **kw: pytest.fail("blockwise below 2048"))
    q, k, v, _, _ = inputs(1, 2047, 2047, 1, 16, None, seed=1)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    torch.testing.assert_close(flash_attention(*t), einsum_attention(*t), **TOL)
