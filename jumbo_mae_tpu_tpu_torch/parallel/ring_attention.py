"""Ring attention: sequence parallelism over the mesh's ``seq`` axis.

Counterpart of ``jumbo_mae_tpu_tpu/parallel/ring_attention.py``. The
sequence is cut into ``n`` shards; each shard keeps its query block while
the K/V blocks rotate around the ring, one hop per step, so after ``n``
hops every query block has met every key block:

- ``inner="einsum"``: each hop is an online-softmax step (running max m,
  denominator l, float32 accumulator), the key-mask bias rotating with its
  K/V block so pad keys never take weight (``ring_attention.py:74-121``);
- ``inner="flash"``: each hop is one call of K4,
  :func:`~jumbo_mae_tpu_tpu_torch.ops.flash_attention.flash_attention_with_lse`,
  and the hops merge as a two-way log-sum-exp in float32
  (``ring_attention.py:124-172``). The merge weights are functions of lse,
  so its cotangent must reach q and k: that is what K4's backward
  (D ← D − g_lse) is for. Even splits only.

Two transports carry the rotation, behind one interface (``size``,
``shard``, ``rotate``, ``unshard``):

- :class:`ProcessGroupRing` — one shard per process of the ``seq``
  subgroup; shard i sends to i + 1 and receives from i − 1
  (``dist.batch_isend_irecv``: NCCL on the card, gloo on the CPU);
- :class:`StackedRing` — all ``n`` shards in one process, stacked on the
  batch axis; a rotation is a roll of that axis, so shard i holds block
  (i − t) mod n at hop t, as ``ppermute`` with ``perm=[(i, i+1)]`` gives.
  Each hop runs once over the ``n``·batch folded shards.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from jumbo_mae_tpu_tpu_torch.ops.flash_attention import einsum_attention, flash_attention_with_lse
from jumbo_mae_tpu_tpu_torch.parallel.mesh import Mesh, ambient_mesh

NEG_INF = -1e30
INNERS = ("einsum", "flash")


class StackedRing:
    """The ``n`` shards of a ring in one process: a (B, S, ...) tensor's
    shards are stacked shard-major on the batch axis, (n·B, S/n, ...)."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring needs at least one shard, got {n}")
        self.size = n

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        b, s, *rest = x.shape
        n = self.size
        return x.reshape(b, n, s // n, *rest).transpose(0, 1).reshape(n * b, s // n, *rest)

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        nb, s, *rest = x.shape
        n = self.size
        return x.reshape(n, nb // n, s, *rest).transpose(0, 1).reshape(nb // n, n * s, *rest)

    def rotate(self, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        n = self.size
        return tuple(torch.roll(x.unflatten(0, (n, -1)), 1, dims=0).flatten(0, 1) for x in xs)


class _Rotate(torch.autograd.Function):
    """Send each tensor to the next rank and receive the previous rank's;
    the backward sends each gradient the other way."""

    @staticmethod
    def forward(ctx, ring: "ProcessGroupRing", *xs):
        ctx.ring = ring
        return ring.exchange(xs, to=ring.next, frm=ring.prev)

    @staticmethod
    def backward(ctx, *gs):
        ring = ctx.ring
        return (None, *ring.exchange(gs, to=ring.prev, frm=ring.next))


class _TakeChunk(torch.autograd.Function):
    """This rank's chunk of a sequence every rank holds whole. The
    backward all-gathers the chunks' gradients: each rank then holds the
    whole gradient, as it holds the whole input (a reduce-scatter would
    multiply it by the ring's size)."""

    @staticmethod
    def forward(ctx, ring: "ProcessGroupRing", x):
        ctx.ring = ring
        s = x.shape[1] // ring.size
        return x[:, ring.rank * s : (ring.rank + 1) * s].contiguous()

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ring.gather(g)


class _GatherChunks(torch.autograd.Function):
    """The whole sequence from every rank's chunk; the backward keeps this
    rank's chunk of the (equal on every rank) gradient."""

    @staticmethod
    def forward(ctx, ring: "ProcessGroupRing", x):
        ctx.ring = ring
        return ring.gather(x)

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        s = g.shape[1] // ring.size
        return None, g[:, ring.rank * s : (ring.rank + 1) * s].contiguous()


class ProcessGroupRing:
    """One shard per process of ``group`` (the mesh's ``seq`` subgroup)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self.prev = dist.get_global_rank(group, (self.rank - 1) % self.size)

    def exchange(self, xs, *, to: int, frm: int) -> tuple[torch.Tensor, ...]:
        xs = [x.contiguous() for x in xs]
        outs = [torch.empty_like(x) for x in xs]
        ops = [dist.P2POp(dist.isend, x, to, self.group) for x in xs]
        ops += [dist.P2POp(dist.irecv, y, frm, self.group) for y in outs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(outs)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=1)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return _TakeChunk.apply(self, x)

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherChunks.apply(self, x)

    def rotate(self, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return _Rotate.apply(self, *xs)


def mesh_ring(mesh: Mesh) -> StackedRing | ProcessGroupRing:
    """The transport of ``mesh``'s ``seq`` axis."""
    if mesh.one_process_seq:
        return StackedRing(mesh.shape["seq"])
    return ProcessGroupRing(mesh.group("seq"))


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    ring: StackedRing | ProcessGroupRing,
    inner: str = "einsum",
) -> torch.Tensor:
    """Attention of this shard's queries over every shard's keys.

    q, k, v: the shard's (batch, local_seq, heads, head_dim), queries
    pre-scaled; ``kv_mask`` an optional (batch, local_seq) bool marking the
    real keys, which rotates with its block. Returns the shard's output
    in q's dtype."""
    if inner not in INNERS:
        raise ValueError(f"unknown ring inner {inner!r}; choose from {INNERS}")
    if inner == "flash":
        if kv_mask is not None:
            raise ValueError(
                "inner='flash' supports even sequence splits only "
                "(kv_mask must be None — pad-free sharding)"
            )
        return _ring_flash(q, k, v, ring)
    n = ring.size
    bq, sq, h, d = q.shape
    qf = q.float()
    m = torch.full((bq, h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bq, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bq, sq, h, d), dtype=torch.float32, device=q.device)
    bias = None if kv_mask is None else torch.where(kv_mask, 0.0, NEG_INF)[:, None, None, :]
    for hop in range(n):
        if hop < n - 1:  # the block this shard attends next
            k_nxt, v_nxt = ring.rotate(k, v)
            bias_nxt = None if bias is None else ring.rotate(bias)[0]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
        if bias is not None:
            s = s + bias
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
        acc = acc * alpha.transpose(1, 2) + pv
        m = m_new
        if hop < n - 1:
            k, v, bias = k_nxt, v_nxt, bias_nxt
    return (acc / l.transpose(1, 2)).to(q.dtype)


def _ring_flash(q, k, v, ring) -> torch.Tensor:
    """The flash hops: K4 per hop, merged in lse space. ``out0`` is zero
    and ``lse0`` is −1e30 (not −inf), so hop 0's previous weight is
    exactly 0 and no NaN forms."""
    n = ring.size
    bq, sq, h, d = q.shape
    out = torch.zeros((bq, sq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((bq, sq, h, 1), NEG_INF, dtype=torch.float32, device=q.device)
    for hop in range(n):
        if hop < n - 1:
            k_nxt, v_nxt = ring.rotate(k, v)
        out_h, lse_h = flash_attention_with_lse(q, k, v)
        lse_h = lse_h.reshape(bq, h, sq).transpose(1, 2)[..., None]  # (b, sq, h, 1)
        m_new = torch.maximum(lse, lse_h)
        w_prev = torch.exp(lse - m_new)
        w_h = torch.exp(lse_h - m_new)
        denom = w_prev + w_h
        out = out * (w_prev / denom) + out_h.float() * (w_h / denom)
        lse = m_new + torch.log(denom)
        if hop < n - 1:
            k, v = k_nxt, v_nxt
    return out.to(q.dtype)


def ring_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh | None = None,
    inner: str = "einsum",
) -> torch.Tensor:
    """Sequence-parallel self-attention over the ambient mesh (or
    ``mesh``): global (batch, seq, heads, head_dim) inputs, queries
    pre-scaled, the same on every seq rank; returns the global output.

    No mesh, or a ``seq`` axis of 1: plain einsum attention. A length the
    ``seq`` axis does not divide: the einsum inner pads K/V and masks the
    pad keys; the flash inner raises ``ValueError`` (K4 masks no keys)."""
    if inner not in INNERS:
        raise ValueError(f"unknown ring inner {inner!r}; choose from {INNERS}")
    mesh = mesh or ambient_mesh()
    n = 1 if mesh is None else mesh.shape["seq"]
    if n <= 1:
        return einsum_attention(q, k, v)
    ring = mesh_ring(mesh)
    b, s = q.shape[:2]
    pad = -s % n
    if not pad:
        out = ring_attention(*(ring.shard(x) for x in (q, k, v)), ring=ring, inner=inner)
        return ring.unshard(out)
    if inner == "flash":
        raise ValueError(
            "inner='flash' requires the sequence length to divide the "
            f"'seq' axis ({s} over {n} shards needs padding, and the flash "
            "kernels mask trailing pad only)"
        )
    q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    kv_mask = (torch.arange(s + pad, device=q.device) < s).expand(b, s + pad)
    out = ring_attention(*(ring.shard(x) for x in (q, k, v, kv_mask)), ring=ring, inner=inner)
    return ring.unshard(out)[:, :s]


def ring_attention_sharded(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *, inner: str = "einsum"
) -> torch.Tensor:
    """Explicit-mesh alias of :func:`ring_self_attention`."""
    return ring_self_attention(q, k, v, mesh=mesh, inner=inner)
