"""The port's CUDA kernels, serving path and train step on the card.

These tests need an NVIDIA GPU with ``nvcc`` and carry the ``cuda``
marker; without a card they skip (the decision is taken inside a
fixture). On the GPU machine, which has no JAX, run them without the
suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports no JAX. ``chip_smoke.py`` covers the same ground at
the full serving and training shapes and widths; these are the quick
checks.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu_torch.data.synthetic import synthetic_batches
from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
from jumbo_mae_tpu_tpu_torch.models import DecoderConfig, preset
from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa
from jumbo_mae_tpu_tpu_torch.ops.flash_attention import flash_attention
from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
from jumbo_mae_tpu_tpu_torch.train.steps import create_state, make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
    return (q * shape[-1] ** -0.5).to(dtype), k.to(dtype), v.to(dtype)


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# K1's shapes are chip_smoke.py's (its main-path shapes and every tile
# edge), after four quick ones
_CS = _chip_smoke()
EDGE_SHAPES = [(2, 199, 4, 64), (3, 52, 2, 32), (1, 259, 3, 80), (2, 70, 2, 128), *_CS.KERNEL_SHAPES]


@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype)
    before = fa.LAUNCHES
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref_o, ref_lse = fa.flash_attention_fwd_plain(q, k, v, with_lse=True)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=0.0)
    torch.testing.assert_close(o, ref_o, **tol)
    torch.testing.assert_close(lse, ref_lse, **tol)
    if dtype == torch.bfloat16:  # no atomics: a rerun is bit-identical
        o2, lse2 = fa.flash_attention_fwd(q, k, v, with_lse=True)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("shape,sk", _CS.CROSS_SHAPES)
def test_kernel_cross_lengths(cuda, shape, sk):
    q, _, _ = _qkv(shape, torch.bfloat16, seed=1)
    _, k, v = _qkv((shape[0], sk, *shape[2:]), torch.bfloat16, seed=2)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    ref_o, ref_lse = fa.flash_attention_fwd_plain(q, k, v, with_lse=True)
    torch.testing.assert_close(o, ref_o, atol=2e-2, rtol=0.0)
    torch.testing.assert_close(lse, ref_lse, atol=2e-2, rtol=0.0)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, with_lse=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _qkv((1, 16, 2, 48), torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _qkv((1, 16, 2, 64), torch.float32)
    # inputs that need a gradient now go through K1 and back through K2/K3
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    do = torch.randn_like(q)
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
    grads = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == tuple(n + 1 for n in before)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(fa.flash_attention_fwd_plain(*plain), plain, do)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="devices"):
        fa.flash_attention_fwd(q, k.cpu(), v)


def test_engine_routes_every_block_through_the_kernel(cuda):
    cfg = preset("vit_t16", heads=2, image_size=32, patch_size=4, labels=10, posemb="sincos2d")
    eng = InferenceEngine(cfg, max_batch=8, device="cuda")
    cpu = InferenceEngine(cfg, max_batch=8, dtype="float32", device="cpu")
    gpu32 = InferenceEngine(cfg, max_batch=8, dtype="float32", device="cuda")
    x = np.random.default_rng(0).integers(0, 256, (11, 32, 32, 3), dtype=np.uint8)
    fa.LAUNCHES, eng.dispatches = 0, 0
    out = eng.logits(x)
    assert out.shape == (11, 10) and np.isfinite(out).all()
    assert eng.dispatches == 2 and fa.LAUNCHES == cfg.layers * 2
    np.testing.assert_allclose(gpu32.logits(x), cpu.logits(x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 52, 4, 64), (2, 199, 3, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain(cuda, shape, dtype):
    """K2 (dq) and K3 (dk, dv) against the plain backward: f32 at atol/rtol
    1e-4 (sum order), bf16 within 3e-2 of the largest reference entry (P
    and dS rounded to bf16 before their products); two runs bit-identical."""
    q, k, v = _qkv(shape, dtype)
    do = torch.randn(shape, device="cuda").to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    before = fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == (before[0] + 1, before[1] + 1)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
        else:
            assert (g.float() - r.float()).abs().max() <= 3e-2 * r.float().abs().max()
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_tiny_mae_train_step_on_the_card(cuda):
    """Two pretraining steps of a tiny MAE model through the kernels:
    every attention call of the forward, the checkpoint recompute and the
    backward is counted, the loss is finite."""
    enc = preset("vit_t16", labels=None, mask_ratio=0.75, image_size=64, patch_size=8,
                 heads=2, posemb="sincos2d", grad_ckpt=True)
    dec = DecoderConfig(layers=1, dim=64, heads=2)
    state = create_state((enc, dec, True), OptimConfig(warmup_steps=0, training_steps=10, mu_dtype="bfloat16"),
                         device="cuda", global_batch_size=4)
    step = make_train_step(guard_nonfinite=True)
    batches = synthetic_batches(4, 64, distinct=1)
    fa.LAUNCHES = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = 0
    for _ in range(2):
        state, m = step(state, next(batches))
        assert np.isfinite(m["loss"].item()) and m["skipped"] == 0.0
    # per step: K2 = K3 = encoder + decoder layers; K1 twice per checkpointed block
    assert fa.LAUNCHES_BWD_DQ == fa.LAUNCHES_BWD_DKV == 2 * (enc.layers + dec.layers)
    assert fa.LAUNCHES == 2 * (2 * enc.layers + dec.layers)
    assert state.step == 2 and state.opt_state.count == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain_with_lse_cotangent(cuda, dtype):
    """K4 (K1 with lse; K2/K3 with D − g_lse) against its plain version
    under random cotangents of o and lse, at the K1/K2/K3 gates."""
    from jumbo_mae_tpu_tpu_torch.ops.flash_attention import flash_attention_with_lse

    shape = (8, 13, 4, 64)
    q, k, v = _qkv(shape, dtype, seed=5)
    g_o = torch.randn(shape, device="cuda").to(dtype)
    g_lse = torch.randn((shape[0] * shape[2], shape[1]), device="cuda")
    out = {}
    for name, fn in (("kernel", flash_attention_with_lse), ("plain", fa.flash_attention_with_lse_plain)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = fa.LAUNCHES_WITH_LSE
        o, lse = fn(*leaves)
        out[name] = [o, lse, *torch.autograd.grad((o, lse), leaves, (g_o, g_lse))]
        torch.cuda.synchronize()
        assert fa.LAUNCHES_WITH_LSE == before + (name == "kernel")
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=0.0)
    for g, r in zip(out["kernel"][:2], out["plain"][:2]):
        torch.testing.assert_close(g.detach(), r.detach(), **tol)
    for g, r in zip(out["kernel"][2:], out["plain"][2:]):
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
        else:
            assert (g.float() - r.float()).abs().max() <= 3e-2 * r.float().abs().max()


def test_seq_parallel_mae_step_on_the_card(cuda):
    """Two steps of a tiny MAE model with the encoder on the flash ring and
    the decoder on the einsum ring of a one-process seq = 4 mesh: one K4
    call per hop, in the forward and again in the checkpoint recompute."""
    from jumbo_mae_tpu_tpu_torch.parallel import MeshConfig, create_mesh, set_mesh

    enc = preset("vit_t16", labels=None, mask_ratio=0.75, image_size=64, patch_size=8, heads=2,
                 posemb="sincos2d", grad_ckpt=True, attn_impl="ring", ring_inner="flash",
                 num_cls_tokens=4)  # 4 CLS + 16 visible = 20 tokens: 4 shards of 5
    dec = DecoderConfig(layers=1, dim=64, heads=2, attn_impl="ring")
    mesh = create_mesh(MeshConfig(data=1, fsdp=1, seq=4), device="cuda", one_process_seq=True)
    with set_mesh(mesh):
        state = create_state((enc, dec, True), OptimConfig(warmup_steps=0, training_steps=10), device="cuda",
                             global_batch_size=4)
        step = make_train_step()
        batches = synthetic_batches(4, 64, distinct=1)
        fa.LAUNCHES = fa.LAUNCHES_WITH_LSE = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = 0
        for _ in range(2):
            state, m = step(state, next(batches))
            assert np.isfinite(m["loss"].item())
    assert fa.LAUNCHES_WITH_LSE == fa.LAUNCHES == 2 * 2 * enc.layers * 4
    assert fa.LAUNCHES_BWD_DQ == fa.LAUNCHES_BWD_DKV == 2 * enc.layers * 4
