"""The port's CUDA kernel and serving path on the card.

These tests need an NVIDIA GPU with ``nvcc`` and carry the ``cuda``
marker; without a card they skip (the decision is taken inside a
fixture). On the GPU machine, which has no JAX, run them without the
suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports no JAX. ``chip_smoke.py`` covers the same ground at
the full serving shapes and widths; these are the quick checks.
"""

import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
from jumbo_mae_tpu_tpu_torch.models import preset
from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa

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


@pytest.mark.parametrize("shape", [(2, 199, 4, 64), (3, 52, 2, 32), (1, 259, 3, 80), (2, 70, 2, 128)])
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


def test_kernel_cross_lengths(cuda):
    q, _, _ = _qkv((2, 40, 4, 64), torch.bfloat16, seed=1)
    _, k, v = _qkv((2, 130, 4, 64), torch.bfloat16, seed=2)
    torch.testing.assert_close(
        fa.flash_attention_fwd(q, k, v), fa.flash_attention_fwd_plain(q, k, v), atol=2e-2, rtol=0.0
    )


def test_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _qkv((1, 16, 2, 48), torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _qkv((1, 16, 2, 64), torch.float32)
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention_fwd(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="devices"):
        fa.flash_attention_fwd(q.detach(), k.cpu(), v)


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
