"""Flash attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``jumbo_mae_tpu_tpu/ops/pallas/attention.py``: the forward
(``_fwd_kernel``, K1) and the two backward kernels (``_bwd_dq_kernel``,
K2, and ``_bwd_dkv_kernel``, K3). The kernels are ``csrc/flash_fwd.cu``
and ``csrc/flash_bwd.cu``; this module checks arguments, allocates the
outputs and launches them on PyTorch's current stream.

- :func:`flash_attention_fwd` launches K1 for CUDA tensors — or raises;
  there is no fallback — and takes the plain version only for CPU tensors.
  ``LAUNCHES`` counts K1's launches.
- :func:`flash_attention_bwd` computes D = rowsum(dO ∘ O)
  (:func:`attention_delta`, plain torch) and launches K2, then K3, for
  CUDA tensors; CPU tensors take :func:`flash_attention_bwd_plain`.
  ``LAUNCHES_BWD_DQ`` and ``LAUNCHES_BWD_DKV`` count their launches.
- :func:`flash_attention_fwd_plain` and :func:`flash_attention_bwd_plain`
  are the same functions in plain PyTorch, float32 inside. They are what
  the CPU runs and what the kernels are held against on the card.
- K4 (``pallas_flash_attention_with_lse``, ``attention.py:396-433``) is no
  tile program of its own: it is K1 returning lse, and K2 + K3 with D
  shifted by the lse cotangent, ``D ← D − g_lse`` (``attention.py:298-305``;
  ∂lse/∂s_j = p_j, so ds = p·(dp − (D − g_lse))). Its forward wrapper
  :func:`flash_attention_with_lse_fwd` counts in ``LAUNCHES_WITH_LSE``;
  :func:`lse_cotangents` turns (g_o, g_lse) into the kernels' (dO, D).
  :func:`flash_attention_with_lse_plain` is its plain version, with a
  plain backward taking both cotangents.

q, k, v are (batch, seq, heads, head_dim) with q already scaled by
``head_dim**-0.5``; the backward's dq is the gradient w.r.t. that scaled
q. lse and D are float32 (batch·heads, seq_q) with row ``b·heads + h``,
the layout of the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (32, 64, 80, 128)
# head_dims whose bf16 forward loads through TMA tensor maps (80 does not)
TMA_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the process started (or the caller last reset
# them): K1, K2 and K3. Only the launches below add to them; the plain
# versions do not.
LAUNCHES = 0
LAUNCHES_BWD_DQ = 0
LAUNCHES_BWD_DKV = 0
LAUNCHES_WITH_LSE = 0  # K4's forward (its K1 launch counts in LAUNCHES too)


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, with_lse: bool = False
):
    """softmax(q·kᵀ)·v in plain PyTorch, float32 inside.

    Returns ``o`` (the shape and dtype of q), or ``(o, lse)``."""
    b, sq, h, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.float())
    o = o.to(q.dtype)
    if not with_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b * h, sq)


def check_kernel_args(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, forward: bool = True
) -> None:
    """Raise ``ValueError`` for anything the kernel does not take.

    It takes (B, S, H, D) tensors of one dtype (float32 or bfloat16) with
    k and v of one shape, q sharing their batch, heads and head_dim;
    head_dim in :data:`HEAD_DIMS`; a unit innermost stride; and 16-byte
    alignment of the base pointer and of every other stride, which its
    vector loads need. The bf16 forward (``forward``) at
    :data:`TMA_HEAD_DIMS` loads through TMA tensor maps, which also need
    every stride of a dimension longer than 1 positive and below 2**40
    bytes (no broadcast views). Devices are checked by the caller.

    Each tensor's shape and strides are read once: the wrapper runs this
    on every launch, and the step that launches it is host-bound."""
    qs, ks, vs = q.shape, k.shape, v.shape
    if not (len(qs) == len(ks) == len(vs) == 4):
        raise ValueError(
            f"q, k, v must be 4-D (batch, seq, heads, head_dim), got {tuple(qs)}, {tuple(ks)}, {tuple(vs)}"
        )
    if ks != vs:
        raise ValueError(f"k and v shapes differ: {tuple(ks)} vs {tuple(vs)}")
    b, _, h, d = qs
    if (ks[0], ks[2], ks[3]) != (b, h, d):
        raise ValueError(f"q {tuple(qs)} and k {tuple(ks)} disagree on batch, heads or head_dim")
    if 0 in qs or 0 in ks:
        raise ValueError("q, k, v must be non-empty")
    dtype = q.dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {dtype} not supported; use float32 or bfloat16")
    if not (dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel; have {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} and heads {h} must each be <= 65535")
    size = 4 if dtype == torch.float32 else 2
    per16 = 16 // size
    tma = forward and size == 2 and d in TMA_HEAD_DIMS
    for name, x, shape in (("q", q, qs), ("k", k, ks), ("v", v, vs)):
        st = x.stride()
        if st[3] != 1:
            raise ValueError(f"{name} must have a unit head_dim stride, got {st}")
        if st[0] % per16 or st[1] % per16 or st[2] % per16 or x.data_ptr() % 16:
            raise ValueError(f"{name} strides {st} and base pointer must be 16-byte aligned")
        if tma and any(n > 1 and not 0 < s * size < 1 << 40 for n, s in zip(shape[:3], st[:3])):
            raise ValueError(
                f"{name} strides {st}: the TMA tensor map needs each stride of a dimension "
                "longer than 1 in (0, 2**40) bytes"
            )


def declare_signatures(lib) -> None:
    """Declare the C signatures of ``csrc/flash_fwd.cu``'s entry points.
    Without ``argtypes`` ctypes passes every Python int as a 32-bit C int,
    which cuts the pointers and the 64-bit strides."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.jumbo_flash_fwd.argtypes = [p] * 5 + [i] * 6 + [ll] * 12 + [p]
    lib.jumbo_flash_fwd.restype = ctypes.c_int
    lib.jumbo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.jumbo_cuda_error_string.restype = ctypes.c_char_p


def declare_bwd_signatures(lib) -> None:
    """Declare the C signatures of ``csrc/flash_bwd.cu``'s entry points:
    K2 takes 7 pointers, 6 ints and 5 stride triples; K3 8 pointers, 6
    ints and 6 stride triples; both end with the stream."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.jumbo_flash_bwd_dq.argtypes = [p] * 7 + [i] * 6 + [ll] * 15 + [p]
    lib.jumbo_flash_bwd_dq.restype = ctypes.c_int
    lib.jumbo_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 6 + [ll] * 18 + [p]
    lib.jumbo_flash_bwd_dkv.restype = ctypes.c_int
    lib.jumbo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.jumbo_cuda_error_string.restype = ctypes.c_char_p


_DECLARE = {"flash_fwd": declare_signatures, "flash_bwd": declare_bwd_signatures}


def _library(name: str = "flash_fwd"):
    from jumbo_mae_tpu_tpu_torch.ops._build import library

    lib = library(name)
    if lib.jumbo_cuda_error_string.restype is not ctypes.c_char_p:
        _DECLARE[name](lib)
    return lib


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.jumbo_cuda_error_string(err).decode()} (cudaError {err})"
        )


def _device_of(*xs: torch.Tensor) -> torch.device:
    devices = {x.device for x in xs}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, got {dev}")
    return dev


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, with_lse: bool = False
):
    """softmax(q·kᵀ)·v through the CUDA kernel; ``o`` or ``(o, lse)``.

    CPU tensors take :func:`flash_attention_fwd_plain`. CUDA tensors launch
    the kernel, or raise when it cannot take them."""
    global LAUNCHES
    dev = _device_of(q, k, v)
    if dev.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, with_lse=with_lse)
    check_kernel_args(q, k, v)
    b, sq, h, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=dev) if with_lse else None
    lib = _library()
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        _DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
    )
    if dev.index == torch.cuda.current_device():
        err = lib.jumbo_flash_fwd(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:  # the launch goes to the current device: make it q's
        with torch.cuda.device(dev):
            err = lib.jumbo_flash_fwd(*args, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "flash_fwd")
    LAUNCHES += 1
    return (o, lse) if with_lse else o


def attention_delta(
    o: torch.Tensor, do: torch.Tensor, g_lse: torch.Tensor | None = None
) -> torch.Tensor:
    """D = rowsum(dO ∘ O) in float32, as (batch·heads, seq_q) with row
    ``b·heads + h`` — the per-row term of the softmax backward, computed
    before the kernels as the JAX package computes it
    (``attention.py:293-297``). K4's lse cotangent ``g_lse`` (same layout,
    any strides and float dtype) folds in as ``D − g_lse``."""
    b, s, h, _ = o.shape
    dd = (do.float() * o.float()).sum(-1)  # (b, s, h)
    dd = dd.permute(0, 2, 1).reshape(b * h, s)
    if g_lse is not None:
        dd = dd - g_lse.float().reshape(b * h, s)
    return dd.contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor | None,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    delta: torch.Tensor | None = None,
):
    """(dq, dk, dv) of softmax(q·kᵀ)·v in plain PyTorch, float32 inside.

    P is recomputed from the forward's lse, P = exp(q·kᵀ − lse), as the
    kernels do — this is not autograd of the plain forward. Returns the
    gradients in the input dtypes."""
    b, sq, h, _ = q.shape
    if delta is None:
        delta = attention_delta(o, do)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.reshape(b, h, sq, 1))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernels can read it through its strides, else a
    contiguous copy (an upstream gradient may arrive in any layout)."""
    per16 = 16 // x.element_size()
    ok = x.stride(3) == 1 and x.data_ptr() % 16 == 0 and not any(st % per16 for st in x.stride()[:3])
    return x if ok else x.contiguous()


def _check_bwd_args(q, k, v, do, lse, delta) -> None:
    """Raise ``ValueError`` for backward inputs the kernels do not take:
    q, k, v as for the forward; dO like q, read through its strides; lse
    and D float32 (batch·heads, seq_q), contiguous."""
    check_kernel_args(q, k, v, forward=False)
    b, sq, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    check_kernel_args(do, k, v, forward=False)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b * h, sq) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous float32 {(b * h, sq)}, got {tuple(x.shape)} {x.dtype}"
            )


def _launch_bwd(entry: str, q, k, v, do, lse, delta, outs) -> None:
    dev = q.device
    _check_bwd_args(q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    lib = _library("flash_bwd")
    strides = [st for x in (q, k, v, do, *outs) for st in x.stride()[:3]]
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(x.data_ptr() for x in outs),
            _DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d, *strides,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, entry)


def flash_attention_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """dq through K2, written as contiguous (B, S, H, D) in q's dtype.
    ``delta`` is :func:`attention_delta`. CPU tensors take the plain
    version."""
    global LAUNCHES_BWD_DQ
    if _device_of(q, k, v, do, lse, delta).type == "cpu":
        return flash_attention_bwd_plain(q, k, v, None, lse, do, delta=delta)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("jumbo_flash_bwd_dq", q, k, v, do, lse, delta, (dq,))
    LAUNCHES_BWD_DQ += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) through K3, written as contiguous (B, S, H, D) in k's and
    v's dtype. CPU tensors take the plain version."""
    global LAUNCHES_BWD_DKV
    if _device_of(q, k, v, do, lse, delta).type == "cpu":
        return flash_attention_bwd_plain(q, k, v, None, lse, do, delta=delta)[1:]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("jumbo_flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv))
    LAUNCHES_BWD_DKV += 1
    return dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    delta: torch.Tensor | None = None,
):
    """(dq, dk, dv) through the CUDA kernels K2 (dq) then K3 (dk, dv).

    ``delta`` defaults to :func:`attention_delta` of (o, do). CPU tensors
    take :func:`flash_attention_bwd_plain`. CUDA tensors launch the
    kernels, or raise when they cannot take them; an upstream gradient
    the kernels cannot read through its strides is made contiguous."""
    dev = _device_of(q, k, v, o, lse, do)
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, delta=delta)
    if delta is None:
        delta = attention_delta(o, do)
    do, lse, delta = _kernel_layout(do), lse.contiguous(), delta.contiguous()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta))


def flash_attention_with_lse_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K4's forward: ``(o, lse)`` through K1, lse float32 (B·H, S_q).

    CPU tensors take :func:`flash_attention_fwd_plain`; a launch on CUDA
    tensors adds one to ``LAUNCHES_WITH_LSE`` (and K1's to ``LAUNCHES``)."""
    global LAUNCHES_WITH_LSE
    if _device_of(q, k, v).type == "cpu":
        return flash_attention_fwd_plain(q, k, v, with_lse=True)
    out = flash_attention_fwd(q, k, v, with_lse=True)
    LAUNCHES_WITH_LSE += 1
    return out


def lse_cotangents(
    o: torch.Tensor, g_o: torch.Tensor | None, g_lse: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's backward inputs ``(dO, D)`` from the cotangents of o and lse:
    ``None`` stands for zero (an output the caller did not use), so
    ``g_o=None`` gives dO = 0 and ``g_lse=None`` no shift of D."""
    do = torch.zeros_like(o) if g_o is None else g_o
    return do, attention_delta(o, do, g_lse)


class _WithLsePlain(torch.autograd.Function):
    """K4 in plain PyTorch: the plain forward, and the plain backward
    (P recomputed from lse) with D shifted by −g_lse."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.set_materialize_grads(False)
        o, lse = flash_attention_fwd_plain(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        if g_o is None and g_lse is None:
            return None, None, None
        q, k, v, o, lse = ctx.saved_tensors
        do, delta = lse_cotangents(o, g_o, g_lse)
        return flash_attention_bwd_plain(q, k, v, o, lse, do, delta=delta)


def flash_attention_with_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K4's plain version: ``(o, lse)``, differentiable in both through the
    plain backward — the oracle the kernels are held against on the card."""
    return _WithLsePlain.apply(q, k, v)
