"""Transformer building blocks for the Jumbo ViT family, in PyTorch.

Counterpart of ``jumbo_mae_tpu_tpu/models/layers.py`` (the unpacked
serving branches). The flax numerics are kept, not PyTorch's defaults:

- params are float32 and every dense layer computes in the config's
  compute dtype (inputs and params cast on use, as flax's ``dtype=`` does);
- LayerNorm statistics run in float32 with eps 1e-6, the result is cast to
  the compute dtype;
- GELU is the tanh approximation;
- the einsum attention path materializes scores in the compute dtype and
  runs softmax in float32, then casts the probabilities back;
- a LayerScale parameter (float32) times a bf16 branch promotes the
  residual stream to float32, exactly as JAX's type promotion does.

Parameter names mirror the flax tree (q/k/v/out, fc1/fc2, ln1/ln2/ln3,
ls1/ls2/ls3), so ``interop/from_jax.py`` maps one onto the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jumbo_mae_tpu_tpu_torch.models.config import RING_NOT_PORTED, JumboViTConfig
from jumbo_mae_tpu_tpu_torch.ops.flash_attention import flash_attention
from jumbo_mae_tpu_tpu_torch.ops.posemb import sincos2d_positional_embedding

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
    masked: bool = False,
) -> str:
    """Resolve ``attn_impl="auto"`` to a concrete path for one call.

    On a CUDA device, ``"auto"`` takes the hand-written flash kernel for
    every call with no mask and no active dropout (the kernel has neither).
    Everywhere else it takes the einsum path. The H100 crossover between the
    two has not been measured yet (ROADMAP, open questions); the JAX
    package's 512-token rule was measured on a TPU and does not carry over.
    Explicit choices pass through."""
    if impl == "ring":
        raise NotImplementedError(RING_NOT_PORTED)
    if impl != "auto":
        return impl
    use_flash = (
        device_type == "cuda" and not masked and (dropout == 0.0 or deterministic)
    )
    return "flash" if use_flash else "einsum"


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
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class Attention(nn.Module):
    """Multi-head self-attention: q/k/v projections to (heads, head_dim),
    queries pre-scaled by head_dim**-0.5, dropout on the probabilities and
    on the output projection."""

    def __init__(self, cfg: JumboViTConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.q = Dense(cfg.dim, cfg.dim, dt)
        self.k = Dense(cfg.dim, cfg.dim, dt)
        self.v = Dense(cfg.dim, cfg.dim, dt)
        self.out = Dense(cfg.dim, cfg.dim, dt)
        self.attn_drop = nn.Dropout(cfg.dropout)
        self.out_drop = nn.Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        deterministic = not self.training
        b, s, _ = x.shape
        heads, hd = cfg.heads, cfg.head_dim
        q = self.q(x).view(b, s, heads, hd) * hd**-0.5
        k = self.k(x).view(b, s, heads, hd)
        v = self.v(x).view(b, s, heads, hd)

        if mask is not None and cfg.attn_impl == "flash":
            raise ValueError(
                "attn_impl='flash' has no attention-mask support; masked "
                "attention requires attn_impl='einsum' or 'auto'"
            )
        if cfg.attn_impl == "flash" and cfg.dropout > 0.0 and not deterministic:
            raise ValueError(
                "attn_impl='flash' has no attention-probability dropout; "
                "set dropout=0.0 to train"
            )
        impl = resolve_attn_impl(
            cfg.attn_impl,
            device_type=x.device.type,
            dropout=cfg.dropout,
            deterministic=deterministic,
            masked=mask is not None,
        )

        if impl == "flash":
            z = flash_attention(q, k, v).reshape(b, s, cfg.dim)
            out = self.out(z)
        else:
            dt = cfg.compute_dtype
            # scores materialize in the compute dtype; softmax runs in f32
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
            scores = logits.float()
            if mask is not None:
                scores = scores.masked_fill(~mask, float("-inf"))
            probs = self.attn_drop(torch.softmax(scores, dim=-1).to(dt))
            z = torch.einsum("bhqk,bkhd->bhqd", probs, v)  # head-major
            # the output projection contracts (h, d) from the head-major layout
            w = self.out.weight.to(dt).view(cfg.dim, heads, hd)
            out = torch.einsum("bhqd,ohd->bqo", z, w) + self.out.bias.to(dt)
        return self.out_drop(out)


class Mlp(nn.Module):
    """Dense(hidden) → GELU (tanh) → Dense(out), dropout after each dense.
    Also the shared "jumbo MLP" with dim = k·encoder_dim."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype)
        self.drop1 = nn.Dropout(dropout)
        self.drop2 = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop1(F.gelu(self.fc1(x), approximate="tanh"))
        return self.drop2(self.fc2(x))


def make_jumbo_mlp(cfg: JumboViTConfig) -> Mlp:
    """The shared jumbo CLS MLP's one definition: width k·dim, hidden 4·k·dim."""
    k = cfg.num_cls_tokens
    return Mlp(k * cfg.dim, 4 * k * cfg.dim, cfg.dropout, cfg.compute_dtype)


class DropPath(nn.Module):
    """Stochastic depth: drop the whole residual branch per sample. Inert
    in eval mode and at rate 0, which is all serving runs; training with
    a positive rate is the pretraining slice's (ROADMAP queue A2)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0.0:
            raise NotImplementedError(
                "droppath in training is not ported yet: ROADMAP queue A2"
            )
        return x


class JumboBlock(nn.Module):
    """The Jumbo block, unpacked layout.

    Attention over the full sequence; then the patch tokens take the usual
    MLP while the ``num_cls_tokens`` CLS tokens are concatenated to one
    (B, k·dim) vector, LayerNorm'd and passed through the **shared** jumbo
    MLP, which the encoder owns and passes to ``forward``.

    The quirk is kept on purpose: the CLS residual base is the *post-norm*
    vector — ``cc = ln3(concat); cc = cc + ls3 · jumbo_mlp(cc)``.
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

    @staticmethod
    def _scale(ls: torch.Tensor | None, h: torch.Tensor) -> torch.Tensor:
        return h if ls is None else ls * h

    def forward(self, x: torch.Tensor, jumbo_mlp: Mlp) -> torch.Tensor:
        cfg = self.cfg
        k = cfg.num_cls_tokens
        x = x + self.dp1(self._scale(self.ls1, self.attn(self.ln1(x))))

        cls, patches = x[:, :k, :], x[:, k:, :]
        bs = cls.shape[0]
        cc = self.ln3(cls.reshape(bs, k * cfg.dim))
        cc = cc + self.dp3(self._scale(self.ls3, jumbo_mlp(cc)))

        h = self.mlp(self.ln2(patches))
        patches = patches + self.dp2(self._scale(self.ls2, h))
        return torch.cat([cc.reshape(bs, k, cfg.dim), patches], dim=1)


class PatchEmbed(nn.Module):
    """Conv patchify + positional embedding added in 2-D grid shape. Takes
    NHWC images, the JAX layout; returns (B, num_patches, dim)."""

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

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        x = F.conv2d(
            images.permute(0, 3, 1, 2).to(dt),
            self.proj.weight.to(dt),
            self.proj.bias.to(dt),
            stride=cfg.patch_size,
        ).permute(0, 2, 3, 1)  # (B, gh, gw, dim)
        x = x + self.pos_embed.to(x.dtype)
        return x.reshape(x.shape[0], -1, cfg.dim)


class ClassifierHead(nn.Module):
    """Linear head over the pooled features, with an optional BatchNorm
    (linear-probe mode). Runs in float32. The BatchNorm follows flax:
    eps 1e-5 and momentum 0.99, which is PyTorch momentum 0.01."""

    def __init__(self, in_features: int, labels: int, batch_norm: bool):
        super().__init__()
        self.bn = (
            nn.BatchNorm1d(in_features, eps=1e-5, momentum=0.01) if batch_norm else None
        )
        self.fc = nn.Linear(in_features, labels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn is not None:
            x = self.bn(x)
        return self.fc(x)
