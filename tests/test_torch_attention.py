"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors the wrappers run the kernels' plain PyTorch versions; those
are held against the Pallas kernels in interpret mode (as
tests/test_attention.py runs them) — the forward K1 directly, the
backward K2/K3 through ``jax.grad`` of their custom_vjp — and against
``xla_attention`` and torch autograd. float32, atol 2e-5: the same
softmax in float32, summed in another order. The CUDA kernels themselves
are held against the plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.ops.flash_attention import xla_attention
from jumbo_mae_tpu_tpu.ops.pallas.attention import pallas_flash_attention_with_lse
from jumbo_mae_tpu_tpu_torch.models.layers import resolve_attn_impl
from jumbo_mae_tpu_tpu_torch.ops.flash import attention as fa
from jumbo_mae_tpu_tpu_torch.ops.flash_attention import einsum_attention, flash_attention


def qkv(b=2, s=52, h=3, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    return q * d**-0.5, k, v


def as_torch(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize(
    "b,sq,sk,h,d",
    [
        pytest.param(2, 52, 52, 3, 32, id="32-52"),
        pytest.param(2, 199, 199, 3, 32, id="32-199"),
        pytest.param(2, 52, 52, 3, 64, id="64-52"),
        pytest.param(2, 199, 199, 3, 64, id="64-199"),
        # head_dim 80 (ViT-H/14) where the card's K1 tiles differently: the
        # encoder's 67 tokens (a 64-row tile and a ragged one of 3 rows),
        # 65, 13 (4 heads packed per 64-row tile at H = 16), Sq != Sk
        pytest.param(1, 67, 67, 16, 80, id="80-67-h16"),
        pytest.param(1, 65, 65, 16, 80, id="80-65-h16"),
        pytest.param(2, 13, 13, 16, 80, id="80-13-h16"),
        pytest.param(1, 13, 67, 16, 80, id="80-sq13-sk67"),
    ],
)
def test_plain_matches_pallas_interpret(b, sq, sk, h, d):
    q, k, v = qkv(b=b, s=sq, h=h, d=d)
    if sk != sq:
        _, k, v = qkv(b=b, s=sk, h=h, d=d, seed=7)
    ref_o, ref_lse = pallas_flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, 128, True
    )
    o, lse = fa.flash_attention_fwd_plain(*as_torch(q, k, v), with_lse=True)
    assert o.shape == q.shape and lse.shape == (b * h, sq)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-5)


@pytest.mark.parametrize("s", [52, 199])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_matches_xla_attention(s, d):
    q, k, v = qkv(s=s, d=d, seed=1)
    ref = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = fa.flash_attention_fwd_plain(*as_torch(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_lse_rows_are_batch_major_then_head():
    """lse row b·H + h holds the logsumexp of (batch b, head h)."""
    q, k, v = qkv(b=2, s=5, h=3, d=32, seed=2)
    _, lse = fa.flash_attention_fwd_plain(*as_torch(q, k, v), with_lse=True)
    s = np.einsum("qd,kd->qk", q[1, :, 2].astype(np.float64), k[1, :, 2].astype(np.float64))
    ref = np.log(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse[1 * 3 + 2].numpy(), ref, atol=1e-5)


def test_cpu_wrapper_takes_plain_path_and_counts_no_launch():
    q, k, v = as_torch(*qkv(s=52, d=64, seed=3))
    before = fa.LAUNCHES
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    o2 = flash_attention(q, k, v)
    assert fa.LAUNCHES == before
    ref_o, ref_lse = fa.flash_attention_fwd_plain(q, k, v, with_lse=True)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse) and torch.equal(o2, ref_o)


def test_cpu_wrapper_computes_unsupported_head_dim():
    q, k, v = qkv(s=20, d=16, seed=4)
    got = fa.flash_attention_fwd(*as_torch(q, k, v))
    ref = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_plain_keeps_bf16_dtype_and_matches_f32_within_bf16():
    q, k, v = qkv(s=52, d=64, seed=5)
    ref = fa.flash_attention_fwd_plain(*as_torch(q, k, v))
    got = fa.flash_attention_fwd_plain(*as_torch(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=2e-2)


def test_einsum_attention_matches_xla_attention():
    q, k, v = qkv(s=52, d=32, seed=6)
    ref = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(einsum_attention(*as_torch(q, k, v)).numpy(), np.asarray(ref), atol=2e-5)


def _ok(b=2, s=199, h=4, d=64, dtype=torch.bfloat16):
    return [torch.zeros(b, s, h, d, dtype=dtype) for _ in range(3)]


def test_check_kernel_args_accepts_serving_shapes():
    for d in fa.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            fa.check_kernel_args(*_ok(d=d, dtype=dtype))
    # a strided view of a fused qkv projection, (B, S, 3, H, D)[:, :, i]
    qkv_t = torch.zeros(2, 199, 3, 4, 64, dtype=torch.bfloat16)
    fa.check_kernel_args(qkv_t[:, :, 0], qkv_t[:, :, 1], qkv_t[:, :, 2])
    # cross attention: q and k/v lengths may differ
    q, _, _ = _ok(s=52)
    fa.check_kernel_args(q, *_ok(s=199)[1:])


def _bad_cases():
    q, k, v = _ok()
    return {
        "3-D": (q[0], k[0], v[0]),
        "k/v shapes": (q, k, v[:, :100]),
        "heads differ": (q, k[:, :, :2], v[:, :, :2]),
        "float16": [x.half() for x in (q, k, v)],
        "mixed dtypes": (q, k.float(), v),
        "head_dim 48": _ok(d=48),
        "head_dim 256": _ok(d=256),
        "non-unit inner stride": [x.transpose(2, 3).contiguous().transpose(2, 3) for x in (q, k, v)],
        "misaligned stride": [torch.zeros(2, 199, 4, 66, dtype=torch.bfloat16)[..., :64]] * 3,
        "misaligned base": [torch.zeros(2 * 199 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 199, 4, 64)] * 3,
        "empty": _ok(s=0),
        # the bf16 forward's TMA tensor maps need positive strides
        "broadcast batch (TMA)": [x[:1].expand(2, -1, -1, -1) for x in (q, k, v)],
        "broadcast heads (TMA)": [x[:, :, :1].expand(-1, -1, 4, -1) for x in (q, k, v)],
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_check_kernel_args_rejects(case):
    with pytest.raises(ValueError):
        fa.check_kernel_args(*_bad_cases()[case])


def test_tma_stride_rule_binds_only_the_bf16_forward():
    """Broadcast (stride-0) views are refused only where TMA loads them
    and no copy is made: the bf16 forward, at every head_dim (80 since its
    wgmma kernel). The f32 forward and the backward kernels' argument
    check take them; a dimension of extent 1 may have any stride."""
    bf16 = [x[:1].expand(2, -1, -1, -1) for x in _ok()]
    fa.check_kernel_args(*bf16, forward=False)
    fa.check_kernel_args(*[x[:1].expand(2, -1, -1, -1) for x in _ok(dtype=torch.float32)])
    fa.check_kernel_args(*[x[:1].expand(2, -1, -1, -1) for x in _ok(d=80)], forward=False)
    fa.check_kernel_args(*[x[:1].expand(1, -1, -1, -1) for x in _ok()])
    fa.check_kernel_args(*[x[:1].expand(1, -1, -1, -1) for x in _ok(d=80)])
    with pytest.raises(ValueError, match="TMA"):
        fa.check_kernel_args(*bf16)
    with pytest.raises(ValueError, match="TMA"):
        fa.check_kernel_args(*[x[:1].expand(2, -1, -1, -1) for x in _ok(d=80)])
    # per kernel: K1, K2 and K3 each load through TMA at every head_dim
    # (80 among them since K2's wgmma kernel at 80)
    assert set(fa.TMA_HEAD_DIMS) == {"K1", "K2", "K3"}
    for kernel in ("K1", "K2", "K3"):
        assert tuple(fa.TMA_HEAD_DIMS[kernel]) == fa.HEAD_DIMS and 80 in fa.TMA_HEAD_DIMS[kernel]


def test_tma_rule_names_the_views_the_backward_copies():
    """The bf16 backward copies a view no TMA tensor map describes instead
    of refusing it: ``_tma_ok`` is false for a broadcast dimension longer
    than 1 and true for contiguous tensors, fused-projection views and a
    dimension of extent 1 with any stride. Per kernel: at head_dim 80 K2
    and K3 both load through TMA, so both get the copies."""
    x = torch.zeros((2, 9, 4, 64), dtype=torch.bfloat16)
    fused = torch.zeros((2, 9, 3, 4, 64), dtype=torch.bfloat16)[:, :, 1]
    for ok in (x, fused, x[:1].expand(1, -1, -1, -1), x[:, :1]):
        assert fa._tma_ok(ok.shape, ok.stride(), 2)
    for bad in (x[:1].expand(2, -1, -1, -1), x[:, :1].expand(-1, 9, -1, -1), x[:, :, :1].expand(-1, -1, 4, -1)):
        assert not fa._tma_ok(bad.shape, bad.stride(), 2)
    assert not fa._tma_ok((2, 9, 4, 64), (1 << 40, 256, 64, 1), 2)
    # head_dim 80: a fused projection's views (160-byte rows) need no copy
    x80 = torch.zeros((2, 9, 4, 80), dtype=torch.bfloat16)
    fused80 = torch.zeros((2, 9, 3, 4, 80), dtype=torch.bfloat16)[:, :, 1]
    assert fa._tma_ok(fused80.shape, fused80.stride(), 2)
    bcast = x80[:1].expand(2, -1, -1, -1)
    for kernel in ("K2", "K3"):
        got_fused, got_bcast = fa._tma_views(kernel, fused80, bcast)
        assert got_fused is fused80
        assert got_bcast is not bcast
        assert got_bcast.is_contiguous() and torch.equal(got_bcast, bcast)
    for kernel in ("K2", "K3"):  # head_dim 64: both load through TMA
        assert fa._tma_views(kernel, x, x[:1].expand(2, -1, -1, -1))[1].is_contiguous()
    f32 = bcast.float()  # f32 kernels read through strides
    assert fa._tma_views("K3", f32, f32)[1] is f32


_BF16_64 = dict(head_dim=64, dtype=torch.bfloat16)


@pytest.mark.parametrize(
    "kw,want",
    [
        (dict(device_type="cuda", dropout=0.0, deterministic=True, **_BF16_64), "flash"),
        (dict(device_type="cuda", dropout=0.1, deterministic=True, **_BF16_64), "flash"),
        (dict(device_type="cuda", dropout=0.1, deterministic=False, **_BF16_64), "einsum"),
        (dict(device_type="cuda", dropout=0.0, deterministic=True, masked=True, **_BF16_64), "einsum"),
        (dict(device_type="cpu", dropout=0.0, deterministic=True, **_BF16_64), "einsum"),
        # auto takes the kernels only where they run: a kernel head_dim
        # (preset vit_t16 and the smoke recipe have 16, dec_heads=2 256)
        # and a kernel dtype
        (dict(device_type="cuda", dropout=0.0, deterministic=True, head_dim=16, dtype=torch.bfloat16), "einsum"),
        (dict(device_type="cuda", dropout=0.0, deterministic=True, head_dim=256, dtype=torch.bfloat16), "einsum"),
        (dict(device_type="cuda", dropout=0.0, deterministic=True, head_dim=64, dtype=torch.float16), "einsum"),
        (dict(device_type="cuda", dropout=0.0, deterministic=True, head_dim=64, dtype=torch.bfloat16), "flash"),
        (dict(device_type="cuda", dropout=0.0, deterministic=True, head_dim=32, dtype=torch.float32), "flash"),
        (dict(device_type="cuda", dropout=0.0, deterministic=True, head_dim=80, dtype=torch.bfloat16), "flash"),
        (dict(device_type="cuda", dropout=0.0, deterministic=True, head_dim=128, dtype=torch.float32), "flash"),
    ],
)
def test_resolve_auto(kw, want):
    assert resolve_attn_impl("auto", **kw) == want


def test_resolve_auto_follows_the_kernel_head_dims():
    """auto's head_dims are the kernels' own: every one of HEAD_DIMS in
    either kernel dtype takes them, and nothing else does."""
    for d in range(8, 260, 8):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            want = "flash" if d in fa.HEAD_DIMS and dtype in fa.KERNEL_DTYPES else "einsum"
            got = resolve_attn_impl("auto", device_type="cuda", dropout=0.0, deterministic=True,
                                    head_dim=d, dtype=dtype)
            assert got == want, (d, dtype)


def test_resolve_explicit_and_ring():
    kw = dict(device_type="cuda", dropout=0.0, deterministic=True, **_BF16_64)
    assert resolve_attn_impl("einsum", **kw) == "einsum"
    assert resolve_attn_impl("flash", **dict(kw, device_type="cpu")) == "flash"
    # sequence parallelism is ported: "ring" passes through on every device
    assert resolve_attn_impl("ring", **kw) == "ring"
    assert resolve_attn_impl("ring", **dict(kw, device_type="cpu", masked=True)) == "ring"


def test_explicit_flash_still_raises_where_the_kernel_cannot_run():
    """An explicit "flash" passes through at head_dim 16 (no silent
    fallback), and the kernel's argument check then refuses the call."""
    kw = dict(device_type="cuda", dropout=0.0, deterministic=True, dtype=torch.bfloat16)
    assert resolve_attn_impl("flash", head_dim=16, **kw) == "flash"
    q, k, v = as_torch(*qkv(s=9, d=16, seed=3), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 16"):
        fa.check_kernel_args(q, k, v)
    with pytest.raises(ValueError, match="float16"):
        fa.check_kernel_args(*as_torch(*qkv(s=9, d=64, seed=3), dtype=torch.float16))


def test_importing_kernel_modules_builds_nothing():
    """Importing the kernel modules builds nothing: no library is loaded
    until a CUDA tensor reaches the wrapper."""
    from jumbo_mae_tpu_tpu_torch.ops import _build

    assert _build._LIBS == {}
    assert {"flash_fwd", "flash_bwd"} <= set(_build.sources())
    assert jax.default_backend() == "cpu"


_STUB = r"""
long long seen[24];
int jumbo_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                    int dtype, int B, int H, int Sq, int Sk, int D,
                    long long s0, long long s1, long long s2, long long s3,
                    long long s4, long long s5, long long s6, long long s7,
                    long long s8, long long s9, long long s10, long long s11,
                    void* stream) {
  long long v_[24] = {(long long)q, (long long)k, (long long)v, (long long)o,
                      (long long)lse, dtype, B, H, Sq, Sk, D, s0, s1, s2, s3,
                      s4, s5, s6, s7, s8, s9, s10, s11, (long long)stream};
  for (int i = 0; i < 24; ++i) seen[i] = v_[i];
  return 7;
}
const char* jumbo_cuda_error_string(int err) { return "stub error"; }
"""


def test_ctypes_signature_carries_64bit_pointers_and_strides(tmp_path, monkeypatch):
    """The wrapper's ctypes declaration passes pointers and strides at full
    width: a stub with the kernel library's C interface, built with the
    host C compiler, records what it receives."""
    import ctypes
    import shutil
    import subprocess

    from jumbo_mae_tpu_tpu_torch.ops import _build

    cc = shutil.which("cc") or shutil.which("gcc")
    assert cc, "a C compiler is needed to build the ABI stub"
    src, lib_path = tmp_path / "stub.c", tmp_path / "libstub.so"
    src.write_text(_STUB)
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(lib_path), str(src)], check=True)
    stub = ctypes.CDLL(str(lib_path))
    monkeypatch.setattr(_build, "library", lambda name: stub)
    lib = fa._library()
    big = [(1 << 40) + i for i in range(5)]
    strides = [(1 << 33) + i for i in range(12)]
    args = [*big, 1, 64, 12, 199, 199, 64, *strides, (1 << 41) + 3]
    assert lib.jumbo_flash_fwd(*args) == 7
    seen = list((ctypes.c_longlong * 24).in_dll(stub, "seen"))
    assert seen == args
    assert lib.jumbo_cuda_error_string(7) == b"stub error"


# ---------------------------------------------------------------- backward


def _grads_pallas(q, k, v, do):
    """(dq, dk, dv) from jax.grad through the Pallas kernels K1–K3 in
    interpret mode, as tests/test_attention.py runs them."""
    from jumbo_mae_tpu_tpu.ops.pallas.attention import pallas_flash_attention

    def f(q, k, v):
        return jnp.sum(pallas_flash_attention(q, k, v, 128, 128, True) * do)

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize(
    "b,sq,sk,h,d",
    [
        pytest.param(2, 52, 52, 3, 32, id="32-52"),
        pytest.param(2, 199, 199, 3, 32, id="32-199"),
        pytest.param(2, 52, 52, 3, 64, id="64-52"),
        pytest.param(2, 199, 199, 3, 64, id="64-199"),
        # where the card's kernels tile differently: 4 heads packed per
        # 64-row tile at the ring hop's 13 tokens (H = 16), 16 heads at one
        # token, head_dim 128 (K3 in 32-row halves), Sq != Sk both ways
        pytest.param(1, 13, 13, 16, 64, id="hop13-h16"),
        pytest.param(2, 1, 1, 16, 32, id="s1-h16"),
        pytest.param(1, 33, 33, 2, 128, id="d128"),
        pytest.param(1, 13, 52, 16, 64, id="sq13-sk52"),
        pytest.param(1, 40, 7, 4, 32, id="sq40-sk7"),
        # head_dim 80 (ViT-H/14): the encoder's 67 tokens, 65, 13 (packed
        # heads in K2 and K3), Sq != Sk both ways; where K2 packs 16, 4
        # and 2 heads a 64-row tile: one token, 9, 13 queries against 67
        # keys
        pytest.param(1, 67, 67, 16, 80, id="80-67-h16"),
        pytest.param(1, 65, 65, 16, 80, id="80-65-h16"),
        pytest.param(1, 13, 13, 16, 80, id="80-13-h16"),
        pytest.param(1, 67, 13, 16, 80, id="80-sq67-sk13"),
        pytest.param(2, 1, 1, 16, 80, id="80-s1-h16"),
        pytest.param(1, 9, 9, 16, 80, id="80-9-h16"),
        pytest.param(1, 13, 67, 16, 80, id="80-sq13-sk67"),
    ],
)
def test_plain_backward_matches_pallas_interpret(b, sq, sk, h, d):
    """flash_attention_bwd_plain (P recomputed from lse, D = rowsum(dO∘O))
    against jax.grad of the Pallas custom_vjp, whose backward is K2 and
    K3. float32, atol 2e-5: the same arithmetic summed in another order."""
    q, k, v = qkv(b=b, s=sq, h=h, d=d, seed=10)
    if sk != sq:
        _, k, v = qkv(b=b, s=sk, h=h, d=d, seed=12)
    do = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)
    ref = _grads_pallas(q, k, v, do)
    o, lse = fa.flash_attention_fwd_plain(*as_torch(q, k, v), with_lse=True)
    got = fa.flash_attention_bwd_plain(*as_torch(q, k, v), o, lse, torch.from_numpy(do))
    for g, r, x in zip(got, ref, (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 52, 3, 64), (1, 199, 2, 32), (2, 23, 2, 16)])
def test_plain_backward_matches_autograd_and_the_function(shape):
    """The plain backward, the autograd Function on CPU tensors and torch
    autograd through the plain forward agree (float32, atol 2e-5); the
    Function launches nothing on the CPU."""
    rng = np.random.default_rng(12)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    q = q * shape[-1] ** -0.5
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(fa.flash_attention_fwd_plain(*leaves), leaves, torch.from_numpy(do))
    counts = fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV
    via_fn = torch.autograd.grad(flash_attention(*leaves), leaves, torch.from_numpy(do))
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == counts
    o, lse = fa.flash_attention_fwd_plain(*as_torch(q, k, v), with_lse=True)
    plain = fa.flash_attention_bwd(*as_torch(q, k, v), o, lse, torch.from_numpy(do))
    for a, b, c in zip(plain, via_fn, ref):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-5)
        np.testing.assert_allclose(b.numpy(), c.numpy(), atol=2e-5)


def test_delta_layout_and_lse_cotangent_seam():
    """D is (batch·heads, seq) with row b·H + h; passing delta − g_lse
    gives the gradient of Σ o·dO + Σ lse·g_lse (the K4 seam)."""
    rng = np.random.default_rng(13)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 9, 3, 32)).astype(np.float32)) for _ in range(4))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, with_lse=True)
    dd = fa.attention_delta(o, do)
    assert dd.shape == (6, 9) and dd.dtype == torch.float32
    torch.testing.assert_close(dd[1 * 3 + 2], (o[1, :, 2] * do[1, :, 2]).sum(-1))
    g_lse = torch.from_numpy(rng.standard_normal((6, 9)).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o2, lse2 = fa.flash_attention_fwd_plain(*leaves, with_lse=True)
    ref = torch.autograd.grad((o2 * do).sum() + (lse2 * g_lse).sum(), leaves)
    got = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, delta=dd - g_lse)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=2e-5, rtol=0)


def test_per_kernel_wrappers_take_the_plain_path_on_cpu():
    """flash_attention_bwd_dq (K2) returns the plain dq and, as its D,
    attention_delta(o, do, g_lse); flash_attention_bwd_dkv (K3) takes that
    D and returns the plain dk, dv; on CPU tensors no launch is counted.
    Without and with K4's lse cotangent."""
    q, k, v = as_torch(*qkv(s=30, d=64, seed=15))
    rng = np.random.default_rng(16)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, with_lse=True)
    counts = fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV
    for g_lse in (None, torch.from_numpy(rng.standard_normal((2 * 3, 30)).astype(np.float32))):
        dd = fa.attention_delta(o, do, g_lse)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, do, o, lse, g_lse)
        assert torch.equal(delta, dd) and delta.shape == (6, 30) and delta.dtype == torch.float32
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, delta=dd)
        for got, want in zip((dq, dk, dv), ref):
            assert torch.equal(got, want)
        # the whole backward takes the same plain path, g_lse folded into D
        for got, want in zip(fa.flash_attention_bwd(q, k, v, o, lse, do, g_lse=g_lse), ref):
            assert torch.equal(got, want)
    assert (fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == counts


def test_plain_backward_keeps_input_dtypes():
    q, k, v = as_torch(*qkv(s=20, d=32, seed=14), dtype=torch.bfloat16)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, with_lse=True)
    grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, torch.ones_like(o))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3


_BWD_STUB = r"""
long long seen_dq[34];
long long seen_dkv[33];
int jumbo_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* o,
                       const void* lse, const void* g_lse, const void* dd, const void* dq,
                       int dtype, int B, int H, int Sq, int Sk, int D,
                       long long s0, long long s1, long long s2, long long s3, long long s4,
                       long long s5, long long s6, long long s7, long long s8, long long s9,
                       long long s10, long long s11, long long s12, long long s13, long long s14,
                       long long s15, long long s16, long long s17, void* stream) {
  long long v_[34] = {(long long)q, (long long)k, (long long)v, (long long)dout, (long long)o,
                      (long long)lse, (long long)g_lse, (long long)dd, (long long)dq,
                      dtype, B, H, Sq, Sk, D, s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10,
                      s11, s12, s13, s14, s15, s16, s17, (long long)stream};
  for (int i = 0; i < 34; ++i) seen_dq[i] = v_[i];
  return 5;
}
int jumbo_flash_bwd_blocks_per_sm(int which, int D, int* blocks) {
  *blocks = 10 * which + D;
  return 0;
}
int jumbo_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                        const void* lse, const void* dd, const void* dk, const void* dv,
                        int dtype, int B, int H, int Sq, int Sk, int D,
                        long long s0, long long s1, long long s2, long long s3, long long s4,
                        long long s5, long long s6, long long s7, long long s8, long long s9,
                        long long s10, long long s11, long long s12, long long s13, long long s14,
                        long long s15, long long s16, long long s17, void* stream) {
  long long v_[33] = {(long long)q, (long long)k, (long long)v, (long long)o, (long long)lse,
                      (long long)dd, (long long)dk, (long long)dv, dtype, B, H, Sq, Sk, D,
                      s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15,
                      s16, s17, (long long)stream};
  for (int i = 0; i < 33; ++i) seen_dkv[i] = v_[i];
  return 6;
}
const char* jumbo_cuda_error_string(int err) { return "stub error"; }
"""


def test_ctypes_signature_of_the_backward_kernels(tmp_path, monkeypatch):
    """The backward library's ctypes declaration passes every pointer and
    stride at full width (a C stub with its interface records them)."""
    import ctypes
    import shutil
    import subprocess

    from jumbo_mae_tpu_tpu_torch.ops import _build

    cc = shutil.which("cc") or shutil.which("gcc")
    assert cc, "a C compiler is needed to build the ABI stub"
    src, lib_path = tmp_path / "stub.c", tmp_path / "libstub.so"
    src.write_text(_BWD_STUB)
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(lib_path), str(src)], check=True)
    stub = ctypes.CDLL(str(lib_path))
    monkeypatch.setattr(_build, "library", lambda name: stub)
    lib = fa._library("flash_bwd")
    ints = [1, 128, 16, 199, 199, 32]
    args = [*[(1 << 40) + i for i in range(9)], *ints, *[(1 << 33) + i for i in range(18)], (1 << 41) + 1]
    assert lib.jumbo_flash_bwd_dq(*args) == 5
    assert list((ctypes.c_longlong * 34).in_dll(stub, "seen_dq")) == args
    args = [*[(1 << 40) + i for i in range(8)], *ints, *[(1 << 34) + i for i in range(18)], (1 << 41) + 2]
    assert lib.jumbo_flash_bwd_dkv(*args) == 6
    assert list((ctypes.c_longlong * 33).in_dll(stub, "seen_dkv")) == args
    assert lib.jumbo_cuda_error_string(5) == b"stub error"
    assert fa.blocks_per_sm("K3", 64) == 74 and fa.blocks_per_sm("K2", 32) == 32
