"""Transformer building blocks for the Jumbo ViT family, in PyTorch.

Counterpart of ``jumbo_mae_tpu_tpu/models/layers.py``, the token-packed
branch of :class:`JumboBlock` and :func:`segment_attention_mask`
included. The flax numerics are kept, not PyTorch's defaults:

- params are float32 and every dense layer computes in the config's
  compute dtype (inputs and params cast on use, as flax's ``dtype=`` does);
- LayerNorm statistics run in float32 with eps 1e-6, the result is cast to
  the compute dtype;
- GELU is the tanh approximation;
- the einsum attention path materializes scores in the compute dtype and
  runs softmax in float32, then casts the probabilities back;
- a LayerScale parameter (float32) times a bf16 branch promotes the
  residual stream to float32, exactly as JAX's type promotion does;
- Dropout keeps each entry, and DropPath a whole sample's branch, with
  probability 1 − rate and scales it by 1/(1 − rate), as flax's
  ``Dropout`` (broadcast, for DropPath) does. Each site draws from an
  explicit generator of its own, for the global batch: a block derives
  each site's seed from the seed it is given, so a gradient-checkpoint
  recompute draws the same mask, every data layout draws the same masks,
  and (seed, step, micro) replays them. No site draws from torch's
  default generator.

Parameter names mirror the flax tree (q/k/v/out, fc1/fc2, ln1/ln2/ln3,
ls1/ls2/ls3), so ``interop/from_jax.py`` maps one onto the other.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from jumbo_mae_tpu_tpu_torch.models.config import DecoderConfig, JumboViTConfig, checkpoint_policy
from jumbo_mae_tpu_tpu_torch.ops.flash.attention import HEAD_DIMS, KERNEL_DTYPES
from jumbo_mae_tpu_tpu_torch.ops.flash_attention import flash_attention
from jumbo_mae_tpu_tpu_torch.ops.posemb import sincos2d_positional_embedding
from jumbo_mae_tpu_tpu_torch.parallel.mesh import ambient_mesh, batch_rand, set_mesh
from jumbo_mae_tpu_tpu_torch.parallel.ring_attention import ring_self_attention
from jumbo_mae_tpu_tpu_torch.utils.rng import derive_seed, generator

ConfigT = JumboViTConfig | DecoderConfig  # the same attribute surface

TRUNC_STD = 0.02
LN_EPS = 1e-6


def trunc_normal_(t: torch.Tensor, generator: torch.Generator, std: float = TRUNC_STD):
    """Fill ``t`` in place from a normal truncated at ±2 standard
    deviations, times ``std`` — flax's ``truncated_normal(std)``."""
    lo, hi = torch.special.ndtr(torch.tensor([-2.0, 2.0], dtype=torch.float64))
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
    z = torch.special.ndtri(lo + (hi - lo) * u)
    with torch.no_grad():
        t.copy_((z * std).to(t.dtype))
    return t


def resolve_attn_impl(
    impl: str,
    *,
    device_type: str,
    dropout: float,
    deterministic: bool,
    head_dim: int,
    dtype: torch.dtype,
    masked: bool = False,
) -> str:
    """Resolve ``attn_impl="auto"`` to a concrete path for one call.

    On a CUDA device, ``"auto"`` takes the hand-written flash kernels only
    where they run: a head_dim in :data:`~jumbo_mae_tpu_tpu_torch.ops.flash.attention.HEAD_DIMS`,
    a float32 or bfloat16 compute dtype, no mask and no active dropout (the
    kernels have neither). At the MAE shapes they beat the einsum path
    forward and backward on the H100 (PERF.md); any other call, and every
    call off CUDA, takes the einsum path, so no config ``"auto"`` accepts
    fails on the card. The JAX package's 512-token rule was measured on a
    TPU and does not carry over. Explicit choices pass through: an explicit
    ``"flash"`` raises where the kernels cannot run, and ``"ring"``
    (sequence parallelism over the ambient mesh) is taken as asked."""
    if impl != "auto":
        return impl
    use_flash = (
        device_type == "cuda"
        and head_dim in HEAD_DIMS
        and dtype in KERNEL_DTYPES
        and not masked
        and (dropout == 0.0 or deterministic)
    )
    return "flash" if use_flash else "einsum"


def segment_attention_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """Block-diagonal attention mask of a token-packed buffer.

    ``segment_ids`` is (batch, seq) int — ``slot + 1`` on a segment's
    tokens, 0 on padding. A position attends only within its own segment
    (``same id AND id > 0``); the diagonal is OR'd in so an all-pad row
    softmaxes over itself instead of over −inf everywhere, whose NaN
    would reach valid rows through probs·V. Returns (batch, 1, seq, seq)
    bool, broadcast over heads. Masked attention takes the einsum path
    (:func:`resolve_attn_impl` never gives a mask to the kernels)."""
    s = segment_ids
    same = (s[:, :, None] == s[:, None, :]) & (s[:, :, None] > 0)
    eye = torch.eye(s.shape[-1], dtype=torch.bool, device=s.device)[None]
    return (same | eye)[:, None, :, :]


class Dense(nn.Linear):
    """``nn.Linear`` with float32 params that computes in ``dtype``, as
    flax's ``nn.Dense(dtype=...)`` does: input and params cast on use."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: float32 statistics, eps 1e-6, the
    output cast to ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__(dim, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class Attention(nn.Module):
    """Multi-head self-attention: q/k/v projections to (heads, head_dim),
    queries pre-scaled by head_dim**-0.5, dropout on the probabilities and
    on the output projection."""

    def __init__(self, cfg: ConfigT):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.q = Dense(cfg.dim, cfg.dim, dt)
        self.k = Dense(cfg.dim, cfg.dim, dt)
        self.v = Dense(cfg.dim, cfg.dim, dt)
        self.out = Dense(cfg.dim, cfg.dim, dt)
        self.attn_drop = Dropout(cfg.dropout)
        self.out_drop = Dropout(cfg.dropout)

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor | None = None, seed: int | None = None
    ) -> torch.Tensor:
        cfg = self.cfg
        deterministic = not self.training
        b, s, _ = x.shape
        heads, hd = cfg.heads, cfg.head_dim
        q = self.q(x).view(b, s, heads, hd) * hd**-0.5
        k = self.k(x).view(b, s, heads, hd)
        v = self.v(x).view(b, s, heads, hd)

        # the flash and ring paths take no mask and have no probability
        # dropout: both are explicit requests, never silently degraded
        if mask is not None and cfg.attn_impl in ("flash", "ring"):
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r} has no attention-mask support; "
                "masked attention requires attn_impl='einsum' or 'auto'"
            )
        if cfg.attn_impl in ("flash", "ring") and cfg.dropout > 0.0 and not deterministic:
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r} has no attention-probability "
                "dropout; set dropout=0.0 to train"
            )
        impl = resolve_attn_impl(
            cfg.attn_impl,
            device_type=x.device.type,
            dropout=cfg.dropout,
            deterministic=deterministic,
            head_dim=hd,
            dtype=q.dtype,
            masked=mask is not None,
        )
        g_attn, g_out = site_generators(self, cfg.dropout, seed, x.device, 2)

        if impl in ("flash", "ring"):
            if impl == "ring":  # tokens shard over the ambient mesh's "seq" axis
                z = ring_self_attention(q, k, v, inner=cfg.ring_inner)
            else:
                z = flash_attention(q, k, v)
            out = self.out(z.reshape(b, s, cfg.dim))
        else:
            dt = cfg.compute_dtype
            # scores materialize in the compute dtype; softmax runs in f32
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
            scores = logits.float()
            if mask is not None:
                scores = scores.masked_fill(~mask, float("-inf"))
            probs = self.attn_drop(torch.softmax(scores, dim=-1).to(dt), g_attn)
            z = torch.einsum("bhqk,bkhd->bhqd", probs, v)  # head-major
            # the output projection contracts (h, d) from the head-major layout
            w = self.out.weight.to(dt).view(cfg.dim, heads, hd)
            out = torch.einsum("bhqd,ohd->bqo", z, w) + self.out.bias.to(dt)
        return self.out_drop(out, g_out)


class Mlp(nn.Module):
    """Dense(hidden) → GELU (tanh) → Dense(out), dropout after each dense.
    Also the shared "jumbo MLP" with dim = k·encoder_dim."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        g1, g2 = site_generators(self, self.drop1.rate, seed, x.device, 2)
        x = self.drop1(F.gelu(self.fc1(x), approximate="tanh"), g1)
        return self.drop2(self.fc2(x), g2)


def make_jumbo_mlp(cfg: JumboViTConfig) -> Mlp:
    """The shared jumbo CLS MLP's one definition: width k·dim, hidden 4·k·dim."""
    k = cfg.num_cls_tokens
    return Mlp(k * cfg.dim, 4 * k * cfg.dim, cfg.dropout, cfg.compute_dtype)


class Dropout(nn.Module):
    """Dropout of each entry. In training with a positive rate, an entry is
    kept with probability 1 − rate and scaled by 1/(1 − rate), the mask
    drawn from ``generator`` (on the input's device) for the global batch,
    of which a data rank keeps its rows (``parallel.mesh.batch_rand``);
    inert in eval mode and at rate 0."""

    per_sample = False  # one draw per entry (False) or per sample (True)

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError(f"{type(self).__name__.lower()} in training needs an explicit generator")
        keep_prob = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1) if self.per_sample else x.shape
        u = batch_rand(shape, generator=generator, device=x.device)
        return torch.where(u < keep_prob, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(Dropout):
    """Stochastic depth: :class:`Dropout` of the whole residual branch per
    sample."""

    per_sample = True


def site_generators(
    module: nn.Module, rate: float, seed: int | None, device: torch.device, sites: int
) -> list[torch.Generator | None]:
    """One generator per dropout or DropPath site of a module, each seeded
    from (seed, site), or ``None``s when the sites are inert (eval mode or
    rate 0)."""
    if not module.training or rate == 0.0:
        return [None] * sites
    if seed is None:
        raise ValueError(f"dropout and droppath in training need a seed ({type(module).__name__})")
    return [generator(derive_seed(seed, i), device) for i in range(sites)]


# A block's seed, given to its DropPath sites as (seed, 0..2), seeds its
# sub-modules' dropout sites through (seed, site) with these sites
ATTN_SITE, MLP_SITE, JUMBO_MLP_SITE = 3, 4, 5


def sub_seed(seed: int | None, site: int) -> int | None:
    """The seed a block hands to its sub-module ``site``; ``None`` without
    one."""
    return None if seed is None else derive_seed(seed, site)


def maybe_remat(block: nn.Module, cfg: ConfigT) -> Callable:
    """The block itself, or the block under gradient checkpointing when
    ``cfg.grad_ckpt`` is set and a gradient is being recorded: the
    counterpart of ``config.py``'s ``maybe_remat``. Policy ``"none"`` saves
    the block's inputs and recomputes all of it in the backward; ``"dots"``
    and ``"dots_no_batch"`` also keep the matmul outputs that
    :func:`~jumbo_mae_tpu_tpu_torch.models.config.checkpoint_policy`
    marks (a selective checkpoint), so the recompute runs the rest. The
    recompute runs under the ambient mesh of the forward: a CUDA backward
    runs on a thread of PyTorch's own, where no mesh is set."""
    if not cfg.grad_ckpt:
        return block
    policy = checkpoint_policy(cfg.remat_policy)
    context = {} if policy is None else {"context_fn": partial(create_selective_checkpoint_contexts, policy)}

    def run(*args):
        if torch.is_grad_enabled():
            mesh = ambient_mesh()

            def under_mesh(*a):
                with set_mesh(mesh):
                    return block(*a)

            return checkpoint(under_mesh, *args, use_reentrant=False, **context)
        return block(*args)

    return run


class PlainBlock(nn.Module):
    """Pre-norm transformer block of the MAE decoder:
    ``x + dp1(ls1 · attn(ln1(x)))`` then ``x + dp2(ls2 · mlp(ln2(x)))``;
    ``ls1``/``ls2`` exist only with ``layerscale``."""

    def __init__(self, cfg: ConfigT):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.ln1 = LayerNorm(cfg.dim, dt)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm(cfg.dim, dt)
        self.mlp = Mlp(cfg.dim, cfg.hidden_dim, cfg.dropout, dt)
        if cfg.layerscale:
            self.ls1 = nn.Parameter(torch.full((cfg.dim,), 1e-4))
            self.ls2 = nn.Parameter(torch.full((cfg.dim,), 1e-4))
        else:
            self.ls1 = self.ls2 = None
        self.dp1 = DropPath(cfg.droppath)
        self.dp2 = DropPath(cfg.droppath)

    def forward(self, x: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        g1, g2 = site_generators(self, self.cfg.droppath, seed, x.device, 2)
        x = x + self.dp1(_scale(self.ls1, self.attn(self.ln1(x), seed=sub_seed(seed, ATTN_SITE))), g1)
        return x + self.dp2(_scale(self.ls2, self.mlp(self.ln2(x), sub_seed(seed, MLP_SITE))), g2)


def _scale(ls: torch.Tensor | None, h: torch.Tensor) -> torch.Tensor:
    return h if ls is None else ls * h


class JumboBlock(nn.Module):
    """The Jumbo block.

    Attention over the full sequence; then the patch tokens take the usual
    MLP while the ``num_cls_tokens`` CLS tokens are concatenated to one
    (B, k·dim) vector, LayerNorm'd and passed through the **shared** jumbo
    MLP, which the encoder owns and passes to ``forward``.

    The quirk is kept on purpose: the CLS residual base is the *post-norm*
    vector — ``cc = ln3(concat); cc = cc + ls3 · jumbo_mlp(cc)``.

    ``packed`` (the dict :meth:`JumboViT.encode_packed` builds: ``mask``,
    ``segment_ids``, ``cls_pos``, ``cls_index``) switches to the
    token-packed layout: attention takes the block-diagonal segment mask,
    and each segment's CLS tokens sit at its ``cls_index`` positions. The
    per-segment math is the same — gather the k CLS tokens, the same
    ln3/jumbo-MLP/post-norm residual, the patch MLP over every position
    (per token, so CLS and pad positions are inert: CLS positions are
    overwritten and pads are never read), scatter back — so a segment
    computes what its own unpacked row would.
    """

    def __init__(self, cfg: JumboViTConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        k = cfg.num_cls_tokens
        self.ln1 = LayerNorm(cfg.dim, dt)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm(cfg.dim, dt)
        self.mlp = Mlp(cfg.dim, cfg.hidden_dim, cfg.dropout, dt)
        self.ln3 = LayerNorm(k * cfg.dim, dt)
        if cfg.layerscale:
            self.ls1 = nn.Parameter(torch.full((cfg.dim,), 1e-4))
            self.ls2 = nn.Parameter(torch.full((cfg.dim,), 1e-4))
            self.ls3 = nn.Parameter(torch.full((k * cfg.dim,), 1e-4))
        else:
            self.ls1 = self.ls2 = self.ls3 = None
        self.dp1 = DropPath(cfg.droppath)
        self.dp2 = DropPath(cfg.droppath)
        self.dp3 = DropPath(cfg.droppath)

    def forward(
        self, x: torch.Tensor, jumbo_mlp: Mlp, seed: int | None = None, packed: dict | None = None
    ) -> torch.Tensor:
        cfg = self.cfg
        k = cfg.num_cls_tokens
        g1, g2, g3 = site_generators(self, cfg.droppath, seed, x.device, 3)
        mask = None if packed is None else packed["mask"]
        x = x + self.dp1(_scale(self.ls1, self.attn(self.ln1(x), mask, seed=sub_seed(seed, ATTN_SITE))), g1)
        if packed is not None:
            return self._packed_tail(x, jumbo_mlp, seed, packed, g2, g3)

        cls, patches = x[:, :k, :], x[:, k:, :]
        bs = cls.shape[0]
        cc = self.ln3(cls.reshape(bs, k * cfg.dim))
        cc = cc + self.dp3(_scale(self.ls3, jumbo_mlp(cc, sub_seed(seed, JUMBO_MLP_SITE))), g3)

        h = self.mlp(self.ln2(patches), sub_seed(seed, MLP_SITE))
        patches = patches + self.dp2(_scale(self.ls2, h), g2)
        return torch.cat([cc.reshape(bs, k, cfg.dim), patches], dim=1)

    def _packed_tail(self, x, jumbo_mlp, seed, packed, g2, g3) -> torch.Tensor:
        """The block after attention, in the packed layout (rows, budget, dim)."""
        cfg = self.cfg
        k = cfg.num_cls_tokens
        rows, seq, dim = x.shape
        cls_index = packed["cls_index"].long()  # (rows, max_segments, k)
        smax = cls_index.shape[1]
        # each slot's k CLS tokens → the (k·dim) concat of the unpacked branch
        idx = cls_index.reshape(rows, smax * k, 1).expand(rows, smax * k, dim)
        cc = self.ln3(torch.gather(x, 1, idx).reshape(rows, smax, k * dim))
        cc = cc + self.dp3(_scale(self.ls3, jumbo_mlp(cc, sub_seed(seed, JUMBO_MLP_SITE))), g3)

        h = self.mlp(self.ln2(x), sub_seed(seed, MLP_SITE))
        patches = x + self.dp2(_scale(self.ls2, h), g2)

        # the updated CLS tokens back to their positions in the row
        cls_pos = packed["cls_pos"]
        slot0 = (packed["segment_ids"] - 1).clamp_min(0).long()
        pos0 = cls_pos.clamp_min(0).long()
        rows_ix = torch.arange(rows, device=x.device)[:, None]
        cls_vals = cc.reshape(rows, smax, k, dim)[rows_ix, slot0, pos0]
        return torch.where(cls_pos[..., None] >= 0, cls_vals, patches)


class PatchEmbed(nn.Module):
    """Conv patchify + positional embedding added in 2-D grid shape. Takes
    NHWC images, the JAX layout; returns (B, num_patches, dim).

    With ``posemb="sincos2d"`` any patch-aligned resolution embeds (the
    packed path and its parity forward serve mixed resolutions): the
    table of another grid is built once per (grid, device) and kept, so a
    later forward, a captured CUDA graph included, copies nothing from the
    host. A learnable table serves only its own grid."""

    def __init__(self, cfg: JumboViTConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.dim, kernel_size=p, stride=p)
        if cfg.posemb == "learnable":
            self.pos_embed = nn.Parameter(torch.zeros(*cfg.grid, cfg.dim))
        else:
            table = sincos2d_positional_embedding(*cfg.grid, cfg.dim)
            self.register_buffer("pos_embed", torch.from_numpy(table), persistent=False)
        self._tables: dict[tuple, torch.Tensor] = {}  # other grids' sincos2d tables

    def _posemb(self, gh: int, gw: int, device: torch.device) -> torch.Tensor:
        if (gh, gw) == tuple(self.cfg.grid):
            return self.pos_embed
        if self.cfg.posemb != "sincos2d":
            raise ValueError(
                f"a {gh}x{gw} patch grid needs posemb='sincos2d'; the learnable table is {tuple(self.cfg.grid)}"
            )
        key = (gh, gw, str(device))
        table = self._tables.get(key)
        if table is None:
            with torch.inference_mode(False):
                table = torch.from_numpy(sincos2d_positional_embedding(gh, gw, self.cfg.dim)).to(device)
            self._tables[key] = table
        return table

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        x = F.conv2d(
            images.permute(0, 3, 1, 2).to(dt),
            self.proj.weight.to(dt),
            self.proj.bias.to(dt),
            stride=cfg.patch_size,
        ).permute(0, 2, 3, 1)  # (B, gh, gw, dim)
        x = x + self._posemb(x.shape[1], x.shape[2], x.device).to(x.dtype)
        return x.reshape(x.shape[0], -1, cfg.dim)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over (batch, features), in float32.

    Training normalizes with the batch mean and the **biased** batch
    variance, computed as flax computes them (``E[x²] − E[x]²``, clamped
    at 0), and keeps that biased variance in ``running_var``
    (``nn.BatchNorm1d`` keeps the unbiased one); the running statistics
    move as ``momentum · old + (1 − momentum) · batch`` with flax's
    momentum 0.99; eps 1e-5. Eval normalizes with the running statistics.
    The statistics are those of the rows this process holds: one process
    holds the global batch (``train/steps.py`` refuses a data axis above 1
    with a BatchNorm head)."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean(0)
            var = torch.clamp_min((x * x).mean(0) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mean) * mul + self.bias.float()


class ClassifierHead(nn.Module):
    """Linear head over the pooled features, with an optional
    :class:`BatchNorm` (linear-probe mode). Runs in float32."""

    def __init__(self, in_features: int, labels: int, batch_norm: bool):
        super().__init__()
        self.bn = BatchNorm(in_features) if batch_norm else None
        self.fc = nn.Linear(in_features, labels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn is not None:
            x = self.bn(x)
        return F.linear(x, self.fc.weight.float(), self.fc.bias.float())
