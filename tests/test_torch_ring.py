"""K4 and ring attention against the JAX package, on the CPU.

- K4: ``flash_attention_with_lse`` (its plain path on CPU tensors) and
  ``flash_attention_with_lse_plain`` against
  ``pallas_flash_attention_with_lse(interpret=True)``: (o, lse) and the
  gradients of a loss that uses both outputs, so the lse cotangent is
  non-zero. float32, atol/rtol 1e-5 (the same float32 softmax, summed in
  another order).
- Ring op: ``StackedRing`` against ``ring_attention_sharded`` on the
  8-device CPU mesh, seq 2/4/8, both inners, forward and gradients, at
  JAX's own tolerances (``tests/test_ring_attention.py``: 2e-5 forward,
  5e-5 gradients); the uneven lengths 19 and 197 through
  ``ring_self_attention``.
- The model and the step on the ring: ``tests/test_torch_ring_step.py``;
  ``ProcessGroupRing`` over gloo: ``tests/test_torch_gloo.py``.
- The refusals: fsdp/tensor/pipe > 1 (ROADMAP A6), a mask or training
  dropout with ``"ring"``, the flash inner on uneven splits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.ops.flash_attention import xla_attention
from jumbo_mae_tpu_tpu.ops.pallas.attention import pallas_flash_attention_with_lse
from jumbo_mae_tpu_tpu.parallel import MeshConfig as FlaxMeshConfig
from jumbo_mae_tpu_tpu.parallel import create_mesh as flax_create_mesh
from jumbo_mae_tpu_tpu.parallel.ring_attention import ring_attention_sharded as flax_ring_sharded
from jumbo_mae_tpu_tpu.parallel.ring_attention import ring_self_attention as flax_ring_self_attention
from jumbo_mae_tpu_tpu.utils import compat
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.models import layers
from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa
from jumbo_mae_tpu_tpu_torch.ops.flash_attention import einsum_attention, flash_attention, flash_attention_with_lse
from jumbo_mae_tpu_tpu_torch.parallel import (
    MeshConfig,
    StackedRing,
    ambient_mesh,
    create_mesh,
    ring_attention,
    ring_attention_sharded,
    ring_self_attention,
    set_mesh,
)


def qkv(b=2, s=64, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    return q * d**-0.5, k, v


def leaf(x, grad=True):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def stacked_mesh(seq: int):
    return create_mesh(MeshConfig(data=1, fsdp=1, seq=seq), device="cpu", one_process_seq=True)


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("s", [13, 19, 64])
@pytest.mark.parametrize("d", [32, 64])
def test_k4_matches_pallas_interpret_with_lse_cotangent(s, d):
    q, k, v = qkv(b=2, s=s, h=3, d=d, seed=s + d)
    rng = np.random.default_rng(1)
    w = rng.standard_normal(q.shape).astype(np.float32)
    u = rng.standard_normal((2 * 3, s)).astype(np.float32)  # lse is (B·H, S)

    def jax_loss(q, k, v):
        o, lse = pallas_flash_attention_with_lse(q, k, v, 128, 128, True)
        return (o * w).sum() + (lse * u).sum(), (o, lse)

    (_, (ref_o, ref_lse)), ref_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    for fn in (flash_attention_with_lse, fa.flash_attention_with_lse_plain):
        tq, tk, tv = leaf(q), leaf(k), leaf(v)
        o, lse = fn(tq, tk, tv)
        assert lse.shape == (2 * 3, s) and lse.dtype == torch.float32
        ((o * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(u)).sum()).backward()
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_o), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(lse.detach().numpy(), np.asarray(ref_lse), atol=1e-5, rtol=1e-5)
        for got, want in zip((tq.grad, tk.grad, tv.grad), ref_g):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def reference_with_lse(q, k, v):
    """(o, logsumexp) by plain torch ops, differentiated by autograd."""
    b, s, h, _ = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    return o, torch.logsumexp(scores, -1).reshape(b * h, s)


@pytest.mark.parametrize("use", ["both", "o", "lse"])
def test_k4_plain_backward_matches_autograd(use):
    """The plain backward (P from lse, D − g_lse) against torch autograd of
    (o, logsumexp), with either cotangent absent: an unused output
    reaches the backward as ``None`` and counts as zero."""
    q, k, v = qkv(s=21, d=16, seed=3)
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((2 * 4, 21)).astype(np.float32))
    grads = []
    for fn in (fa.flash_attention_with_lse_plain, flash_attention_with_lse, reference_with_lse):
        xs = [leaf(x) for x in (q, k, v)]
        o, lse = fn(*xs)
        terms = {"o": (o * w).sum(), "lse": (lse.t() * u.t()).sum()}  # a transposed g_lse
        loss = terms["o"] + terms["lse"] if use == "both" else terms[use]
        # lse alone does not depend on v: its gradient is zero
        grads.append(torch.autograd.grad(loss, xs, allow_unused=True, materialize_grads=True))
    for got in grads[:2]:
        for g, r in zip(got, grads[2]):
            torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_k4_with_o_only_equals_flash_attention():
    q, k, v = qkv(s=33, d=32, seed=4)
    a = [leaf(x) for x in (q, k, v)]
    b = [leaf(x) for x in (q, k, v)]
    flash_attention_with_lse(*a)[0].sum().backward()
    flash_attention(*b).sum().backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=0)


def test_attention_delta_shifts_by_g_lse():
    o, do = (torch.randn(2, 5, 3, 8) for _ in range(2))
    g_lse = torch.randn(5, 2 * 3).t()  # non-contiguous
    d0 = fa.attention_delta(o, do)
    d1 = fa.attention_delta(o, do, g_lse)
    assert d1.is_contiguous() and d1.dtype == torch.float32
    torch.testing.assert_close(d1, d0 - g_lse, rtol=0, atol=0)


# ------------------------------------------------------------- ring op


@pytest.mark.parametrize("inner", ["einsum", "flash"])
@pytest.mark.parametrize("seq", [2, 4, 8])
def test_stacked_ring_matches_jax_ring(devices, seq, inner):
    q, k, v = qkv(seed=seq)
    w = np.random.default_rng(seq).standard_normal(q.shape).astype(np.float32)
    fmesh = flax_create_mesh(FlaxMeshConfig(data=1, fsdp=1, seq=seq))
    kw = dict(inner=inner, interpret=True) if inner == "flash" else {}

    def jax_loss(q, k, v):
        out = flax_ring_sharded(q, k, v, fmesh, **kw)
        return (out * w).sum(), out

    (_, ref), ref_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    xs = [leaf(x) for x in (q, k, v)]
    out = ring_attention_sharded(*xs, stacked_mesh(seq), inner=inner)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    for x, want in zip(xs, ref_g):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("s", [19, 197])
def test_uneven_lengths_pad_and_mask_like_jax(devices, s):
    q, k, v = qkv(b=4, s=s)
    fmesh = flax_create_mesh(FlaxMeshConfig(data=2, fsdp=1, seq=4))
    with compat.set_mesh(fmesh):
        ref = jax.jit(flax_ring_self_attention)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    with set_mesh(stacked_mesh(4)):
        out = ring_self_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    # the flash inner refuses the split, as JAX's does
    with pytest.raises(ValueError, match="divide"):
        flax_ring_self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh=fmesh, inner="flash")
    with pytest.raises(ValueError, match="divide"):
        ring_self_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh=stacked_mesh(4), inner="flash")


def test_no_mesh_or_seq_one_is_plain_attention():
    q, k, v = (torch.from_numpy(x) for x in qkv(s=16))
    want = einsum_attention(q, k, v)
    assert ambient_mesh() is None
    torch.testing.assert_close(ring_self_attention(q, k, v), want, rtol=0, atol=0)
    torch.testing.assert_close(ring_self_attention(q, k, v, mesh=stacked_mesh(1)), want, rtol=0, atol=0)
    ref = xla_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    np.testing.assert_allclose(want.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_stacked_ring_rotation_follows_ppermute():
    """At hop t shard i holds block (i − t) mod n; shard/unshard invert."""
    ring = StackedRing(4)
    x = torch.arange(3 * 8).reshape(3, 8).float()  # (batch 3, seq 8)
    sh = ring.shard(x)
    assert sh.shape == (12, 2)
    torch.testing.assert_close(ring.unshard(sh), x, rtol=0, atol=0)
    blocks = sh.unflatten(0, (4, 3))
    rot = ring.rotate(ring.rotate(sh)[0])[0].unflatten(0, (4, 3))
    for i in range(4):
        torch.testing.assert_close(rot[i], blocks[(i - 2) % 4], rtol=0, atol=0)


def test_ring_inner_flash_refuses_a_key_mask_and_unknown_inners():
    q, k, v = (torch.from_numpy(x) for x in qkv(s=8))
    with pytest.raises(ValueError, match="kv_mask"):
        ring_attention(q, k, v, torch.ones(2, 8, dtype=torch.bool), ring=StackedRing(1), inner="flash")
    with pytest.raises(ValueError, match="inner"):
        ring_self_attention(q, k, v, inner="splash")
    with pytest.raises(ValueError, match="ring_inner"):
        preset("vit_t16", ring_inner="splash")
    with pytest.raises(ValueError, match="ring_inner"):
        DecoderConfig(ring_inner="splash")


# ------------------------------------------------------------ refusals


def test_mesh_axes_not_ported_raise_naming_a6():
    for cfg in (MeshConfig(data=1, fsdp=2), MeshConfig(data=1, fsdp=1, tensor=2), MeshConfig(pipe=2)):
        with pytest.raises(NotImplementedError, match="A6"):
            create_mesh(cfg, device="cpu", one_process_seq=True)
    # no process group and no explicit one-process ring: a seq axis of 4
    # does not resolve on one device
    with pytest.raises(ValueError, match="available devices"):
        create_mesh(MeshConfig(data=1, fsdp=1, seq=4), device="cpu")
    mesh = stacked_mesh(4)
    assert mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1, "seq": 4}
    assert mesh.data_size == 1 and mesh.data_rank == 0 and mesh.group("seq") is None


def test_mask_and_training_dropout_refuse_ring():
    cfg = preset("vit_t16", image_size=32, patch_size=8, dtype="float32", attn_impl="ring")
    attn = layers.Attention(cfg)
    x = torch.randn(2, 5, cfg.dim)
    with pytest.raises(ValueError, match="mask"):
        attn(x, mask=torch.ones(2, 1, 5, 5, dtype=torch.bool))
    drop = layers.Attention(cfg.replace(dropout=0.1)).train()
    with pytest.raises(ValueError, match="dropout"):
        drop(x)
    drop.eval()(x)  # inference: dropout is inert, the ring runs
