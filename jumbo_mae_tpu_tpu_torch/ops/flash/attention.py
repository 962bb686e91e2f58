"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``jumbo_mae_tpu_tpu/ops/pallas/attention.py``'s forward
(``_fwd_kernel`` launched by ``_flash_fwd``). The kernel is
``csrc/flash_fwd.cu``; this module checks arguments, allocates the outputs
and launches it on PyTorch's current stream.

- :func:`flash_attention_fwd` launches the kernel for CUDA tensors — or
  raises; there is no fallback — and takes the plain version only for CPU
  tensors. ``LAUNCHES`` counts the kernel launches.
- :func:`flash_attention_fwd_plain` is the same function in plain PyTorch:
  scores and softmax in float32, the output cast to the input dtype, lse
  from ``torch.logsumexp``. It is what the CPU runs and what the kernel is
  held against on the card.

q, k, v are (batch, seq, heads, head_dim) with q already scaled by
``head_dim**-0.5``. lse is float32 (batch·heads, seq_q) with row
``b·heads + h``, the layout of the JAX package.

The backward kernels (K2, K3 in ROADMAP queue B) are not ported yet, so
the kernel path refuses inputs that require a gradient instead of
returning an output with no gradient.
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (32, 64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the process started (or the caller last reset it).
# Only the launch below adds to it; the plain version does not.
LAUNCHES = 0


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


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` for anything the kernel does not take.

    It takes (B, S, H, D) tensors of one dtype (float32 or bfloat16) with
    k and v of one shape, q sharing their batch, heads and head_dim;
    head_dim in :data:`HEAD_DIMS`; a unit innermost stride; and 16-byte
    alignment of the base pointer and of every other stride, which its
    vector loads need. Devices are checked by the caller."""
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError(
            "q, k, v must be 4-D (batch, seq, heads, head_dim), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes differ: {tuple(k.shape)} vs {tuple(v.shape)}")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch, "
            "heads or head_dim"
        )
    if 0 in q.shape or 0 in k.shape:
        raise ValueError("q, k, v must be non-empty")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported; use float32 or bfloat16")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel; have {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} and heads {h} must each be <= 65535")
    per16 = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a unit head_dim stride, got {x.stride()}")
        if any(st % per16 for st in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name} strides {x.stride()} and base pointer must be "
                "16-byte aligned"
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


def _library():
    from jumbo_mae_tpu_tpu_torch.ops._build import library

    lib = library("flash_fwd")
    if lib.jumbo_flash_fwd.argtypes is None:
        declare_signatures(lib)
    return lib


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, with_lse: bool = False
):
    """softmax(q·kᵀ)·v through the CUDA kernel; ``o`` or ``(o, lse)``.

    CPU tensors take :func:`flash_attention_fwd_plain`. CUDA tensors launch
    the kernel, or raise when it cannot take them."""
    global LAUNCHES
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {sorted(map(str, devices))}")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, with_lse=with_lse)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, got {dev}")
    check_kernel_args(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "the flash-attention backward kernels are not ported yet "
            "(ROADMAP queue B2/B3); use attn_impl='einsum' to train"
        )
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=dev) if with_lse else None
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.jumbo_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _DTYPE_CODES[q.dtype], b, h, sq, sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: "
            f"{lib.jumbo_cuda_error_string(err).decode()} (cudaError {err})"
        )
    LAUNCHES += 1
    return (o, lse) if with_lse else o
