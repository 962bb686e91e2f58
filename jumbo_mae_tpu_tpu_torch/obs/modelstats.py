"""Per-layer-group model statistics for training diagnostics.

Counterpart of ``jumbo_mae_tpu_tpu/obs/modelstats.py``, with the same
names. When a run diverges, the question is not "did the loss go NaN" (the
sentinel answers that) but *where*: which part of the model blew up
first, and was the update/param ratio drifting before it did. Every
parameter is bucketed into a small set of named **layer groups** —
``patch_embed`` / ``cls`` / ``blocks.N`` / ``jumbo_mlp`` / ``norm`` /
``head`` / ``decoder`` — and the train step computes, on the device,
three numbers per group:

- ``grad_norm``    — L2 norm of the group's gradients
- ``param_norm``   — L2 norm of the group's parameters (before the update)
- ``update_ratio`` — ``||new - old|| / (||old|| + eps)``, the effective
  per-group step size (the number that drifts upward before a blow-up)

stacked into one ``(groups, 3)`` float32 tensor, so the host fetches one
small transfer a diagnostic step instead of a tree of scalars.

The port's leaves are ``named_parameters()`` names (``encoder.blocks.3.
attn.q.weight``, ``model.head.fc.bias``, ``mask_token``); :func:`group_of`
also takes the JAX package's flax key paths (``encoder/block_3/...``) and
maps both spellings to the same group. BatchNorm running statistics are
buffers, not parameters, as JAX keeps them in ``batch_stats``.

Host side, :func:`publish_group_stats` turns the fetched array into
labeled gauges (``model_grad_norm{group=...}`` etc.) and
:func:`stats_dict` into the nested dict the run journal and the flight
recorder store.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from functools import lru_cache

import numpy as np

from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

# Column order of the stacked stats array.
STAT_NAMES = ("grad_norm", "param_norm", "update_ratio")

_METRIC_HELP = {
    "grad_norm": "L2 gradient norm per layer group (diag steps only)",
    "param_norm": "L2 parameter norm per layer group (diag steps only)",
    "update_ratio": "||update|| / ||param|| per layer group (diag steps only)",
}

# Canonical group ordering for display/stacking: input side first, then the
# transformer trunk, then the task-specific tails.
_GROUP_RANK = {
    "patch_embed": 0,
    "cls": 1,
    # blocks.N rank between cls and jumbo_mlp, ordered by N (see _order_key)
    "jumbo_mlp": 3,
    "norm": 4,
    "head": 5,
    "decoder": 6,
    "other": 7,
}


def group_of(path: str | Sequence[str]) -> str:
    """Map one parameter to its layer-group name: a torch name
    (``"encoder.blocks.3.mlp.fc1.weight"``) or a flax key path
    (``["encoder", "block_3", "mlp", "fc1", "kernel"]``).

    Handles both model trees: MAE pretraining (``encoder...`` and the
    decoder-side leaves at top level) and classification (everything under
    ``model...``, the head included)."""
    parts = path.split(".") if isinstance(path, str) else [str(p) for p in path]
    if parts and parts[0] in ("encoder", "model"):
        parts = parts[1:]
    if not parts:
        return "other"
    head = parts[0]
    if head in ("decoder", "decoder_proj", "mask_token", "pixel_proj"):
        return "decoder"
    if head == "embed":
        return "patch_embed"
    if head.startswith("block_"):
        return f"blocks.{head[len('block_'):]}"
    if head == "blocks" and len(parts) > 1:
        return f"blocks.{parts[1]}"
    if head == "cls_tokens":
        return "cls"
    if head == "jumbo_mlp":
        return "jumbo_mlp"
    if head == "head":
        return "head"
    if head == "ln":
        return "norm"
    return "other"


def _order_key(name: str) -> tuple:
    if name.startswith("blocks."):
        try:
            return (2, int(name.split(".", 1)[1]))
        except ValueError:  # pragma: no cover - non-integer block suffix
            return (2, 1 << 30)
    return (_GROUP_RANK.get(name, 7), 0)


def _leaf_names(params) -> tuple[str, ...]:
    """The parameter names of a module, of a name → tensor mapping, or
    the names given as an iterable."""
    if hasattr(params, "named_parameters"):
        return tuple(n for n, _ in params.named_parameters())
    if isinstance(params, Mapping):
        return tuple(params)
    return tuple(params)


@lru_cache(maxsize=16)
def _plan(names: tuple[str, ...]) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """The group layout of ``names`` and each leaf's row in it."""
    groups = [group_of(n) for n in names]
    layout = tuple(sorted(set(groups), key=_order_key))
    row = {g: i for i, g in enumerate(layout)}
    return layout, tuple(row[g] for g in groups)


def group_layout(params) -> tuple[str, ...]:
    """The ordered tuple of group names present in ``params`` (a module,
    a name → tensor mapping, or the names): the static row layout of the
    stacked stats array."""
    return _plan(_leaf_names(params))[0]


def _membership(names: tuple[str, ...], dev):
    """The (G, L) boolean mask of leaf L in group G on ``dev``. The rows go
    to a card from pinned memory without blocking: a pageable copy would
    wait for the stream, a host synchronisation at every diag step."""
    import torch

    layout, rows = _plan(names)
    idx = torch.tensor(rows)
    idx = idx.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else idx
    return idx[None, :] == torch.arange(len(layout), device=dev)[:, None]


def _squared_norms(tensors: list, dev):
    """The leaves' squared L2 norms as one (L,) float32 tensor, a ``None``
    leaf 0: ``torch._foreach_norm`` on the float32 leaves (its fused path)
    and with ``dtype=float32`` on the others (float32 accumulation)."""
    import torch

    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    out = [zero] * len(tensors)
    same = [i for i, t in enumerate(tensors) if t is not None and t.dtype == f32]
    other = [i for i, t in enumerate(tensors) if t is not None and t.dtype != f32]
    for idx, kw in ((same, {}), (other, {"dtype": f32})):
        if idx:
            for i, n in zip(idx, torch._foreach_norm([tensors[i] for i in idx], 2, **kw)):
                out[i] = n
    return torch.stack(out).square()


def group_stats(old, grads, new, names: Sequence[str] | None = None):
    """Per-group (grad_norm, param_norm, update_ratio), stacked ``(G, 3)``
    float32 on the parameters' device; rows in :func:`group_layout` order.

    ``old``, ``grads`` and ``new`` are name → tensor mappings in one order
    (``dict(model.named_parameters())``), or parallel lists with their
    ``names``. A ``None`` (or missing) gradient counts as zero: a linear
    probe's frozen trunk, which the JAX step zeroes by ``stop_gradient``.

    Each leaf's norm comes from ``torch._foreach_norm``, accumulated in
    float32 whatever the stored dtype; the leaves' squares are summed per
    group by a masked sum (no atomics, so a rerun gives the same bits, and
    a NaN stays in its own group). No host synchronisation."""
    import torch

    if isinstance(old, Mapping):
        names = tuple(old)
        grads = [grads.get(n) for n in names] if isinstance(grads, Mapping) else list(grads)
        old = list(old.values())
        new = [new[n] for n in names] if isinstance(new, Mapping) else list(new)
    if names is None:
        raise ValueError("group_stats needs names= with lists of tensors")
    names = tuple(names)
    dev = old[0].device
    f32 = torch.float32
    with torch.no_grad():
        g_sq = _squared_norms(list(grads), dev)
        p_sq = _squared_norms(list(old), dev)
        olds = [t if t.dtype == f32 else t.float() for t in old]
        news = [t if t.dtype == f32 else t.float() for t in new]
        u_sq = _squared_norms(torch._foreach_sub(news, olds), dev)
        member = _membership(names, dev)
        zero = torch.zeros((), dtype=f32, device=dev)
        per_group = [torch.where(member, sq[None, :], zero).sum(dim=1) for sq in (g_sq, p_sq, u_sq)]
        g_norm, p_norm, u_norm = (s.sqrt() for s in per_group)
        return torch.stack([g_norm, p_norm, u_norm / (p_norm + 1e-12)], dim=1)


def stats_dict(names: tuple[str, ...], array) -> dict[str, dict[str, float]]:
    """Fetched ``(G, 3)`` array → ``{group: {stat: float}}`` (journal shape).

    Non-finite values survive as the JSON-safe strings ``"nan"``/``"inf"``
    so a blown-up group is still readable from a journal parsed by strict
    JSON tooling."""
    arr = np.asarray(array, np.float64)
    out: dict[str, dict[str, float]] = {}
    for gi, grp in enumerate(names):
        row = {}
        for si, stat in enumerate(STAT_NAMES):
            v = float(arr[gi, si])
            row[stat] = v if np.isfinite(v) else ("nan" if np.isnan(v) else "inf")
        out[grp] = row
    return out


def publish_group_stats(names: tuple[str, ...], array, registry=None) -> None:
    """Push one fetched stats array into ``model_<stat>{group=...}`` gauges."""
    reg = registry if registry is not None else get_registry()
    arr = np.asarray(array, np.float64)
    for si, stat in enumerate(STAT_NAMES):
        fam = reg.gauge(f"model_{stat}", _METRIC_HELP[stat], labels=("group",))
        for gi, grp in enumerate(names):
            fam.labels(grp).set(float(arr[gi, si]))


def first_nonfinite_group(names: tuple[str, ...], array) -> str | None:
    """The first group (in layout order) whose grad norm is non-finite in
    one stats array — the "where did it blow up" readout ``run_doctor`` and
    the flight recorder lead with. None when every group is finite."""
    arr = np.asarray(array, np.float64)
    for gi, grp in enumerate(names):
        if not np.isfinite(arr[gi, 0]):
            return grp
    return None
