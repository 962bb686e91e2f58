"""Token-packing plans: many variable-length requests, one dispatch.

A copy of ``jumbo_mae_tpu_tpu/infer/packing.py`` (the port keeps its own).
The image-bucketed path pads each dispatch to a per-``(task, shape)``
power-of-two image bucket, so mixed-resolution traffic pads every
resolution to a bucket of its own. Sequence packing (NaViT,
arXiv:2307.06304) turns each request into a variable-length *token
segment* (its CLS slots and patch tokens) and packs segments of several
resolutions into the rows of one ``(rows, token_budget)`` buffer, served
by one forward.

The planner is numpy and deterministic (sorted first-fit-decreasing, ties
broken by request index): the same requests give the same plan, the
JAX package's plan. The device-side arrays it builds:

- ``segment_ids`` (rows, budget) int32: ``slot + 1`` on every token a
  segment owns, 0 on padding; attention is ``same id AND id > 0``, plus
  the diagonal so an all-pad row softmaxes over itself;
- ``cls_pos`` (rows, budget) int32: ``0..k-1`` on a segment's k leading
  CLS slots, -1 elsewhere, where the encoder writes its CLS parameter;
- ``cls_index`` (rows, max_segments, k) int32: each slot's CLS positions,
  for the per-segment jumbo-MLP gather and scatter and for pooling.

Pad tokens attend only to themselves and real tokens never attend to
pads, so perturbing one segment moves no other segment's output.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from jumbo_mae_tpu_tpu_torch.infer.bucketing import bucket_for, pow2_rungs


@dataclass(frozen=True)
class SegmentPlacement:
    """One request's segment inside a pack: ``request`` indexes the
    caller's request list, ``length`` is its token count (k CLS slots plus
    patch tokens), ``row``/``slot`` its row and per-row segment slot,
    ``offset`` the row position of its first token."""

    request: int
    length: int
    row: int
    slot: int
    offset: int


@dataclass(frozen=True)
class PackPlan:
    """A packing of segments into ``rows`` rows of ``budget`` tokens;
    ``max_segments`` is the largest per-row segment count."""

    budget: int
    rows: int
    max_segments: int
    segments: tuple[SegmentPlacement, ...]

    @property
    def total_tokens(self) -> int:
        return sum(s.length for s in self.segments)

    def pad_fraction(self, rows: int | None = None) -> float:
        """Padded tokens / device tokens over ``rows`` rows (default the
        plan's own; pass the row-bucketed count for what the device ran)."""
        r = self.rows if rows is None else int(rows)
        dev = r * self.budget
        return (dev - self.total_tokens) / dev if dev else 0.0


def pack_ffd(lengths, budget: int) -> PackPlan:
    """First-fit-decreasing pack of ``lengths`` token segments into rows of
    ``budget`` tokens: longest first (ties by request index), each into
    the first row with room. A segment longer than the budget raises."""
    budget = int(budget)
    if budget < 1:
        raise ValueError(f"need a positive token budget, got {budget}")
    lengths = [int(n) for n in lengths]
    if not lengths:
        return PackPlan(budget=budget, rows=0, max_segments=0, segments=())
    for i, n in enumerate(lengths):
        if n < 1:
            raise ValueError(f"segment {i} has non-positive length {n}")
        if n > budget:
            raise ValueError(
                f"segment {i} needs {n} tokens > budget {budget} — pick a larger rung "
                "(choose_budget does this automatically)"
            )
    order = sorted(range(len(lengths)), key=lambda i: (-lengths[i], i))
    row_fill: list[int] = []
    row_slots: list[int] = []
    placed: list[SegmentPlacement] = []
    for i in order:
        n = lengths[i]
        for r in range(len(row_fill)):
            if row_fill[r] + n <= budget:
                placed.append(SegmentPlacement(request=i, length=n, row=r, slot=row_slots[r], offset=row_fill[r]))
                row_fill[r] += n
                row_slots[r] += 1
                break
        else:
            placed.append(SegmentPlacement(request=i, length=n, row=len(row_fill), slot=0, offset=0))
            row_fill.append(n)
            row_slots.append(1)
    placed.sort(key=lambda s: s.request)
    return PackPlan(budget=budget, rows=len(row_fill), max_segments=max(row_slots), segments=tuple(placed))


def choose_budget(lengths, rungs, *, max_rows: int | None = None) -> tuple[int, PackPlan]:
    """The rung that minimizes device tokens, ``row-bucketed rows x
    budget`` (rows pad to a power of two as image batches do); ties go to
    the smaller budget. Returns ``(budget, plan)``."""
    need = max(int(n) for n in lengths)
    usable = [b for b in rungs if b >= need]
    if not usable:
        raise ValueError(
            f"largest segment needs {need} tokens but the rung ladder tops out at {max(rungs)} — "
            "raise the packed token budget"
        )
    best = None
    for b in sorted(usable):
        plan = pack_ffd(lengths, b)
        rows_cap = max_rows if max_rows is not None else max(plan.rows, 1)
        total = bucket_for(plan.rows, max(rows_cap, plan.rows)) * b
        if best is None or total < best[0]:
            best = (total, b, plan)
    return best[1], best[2]


def budget_rungs(max_budget: int, *, min_budget: int = 64) -> tuple[int, ...]:
    """Token-budget rungs: powers of two from ``min_budget`` up to
    ``max_budget`` (plus ``max_budget`` when it is not one)."""
    return tuple(b for b in pow2_rungs(max_budget) if b >= min_budget) or (max_budget,)


def build_arrays(
    plan: PackPlan, num_cls_tokens: int, *, rows: int | None = None, max_segments: int | None = None
) -> dict[str, np.ndarray]:
    """The device-side plan arrays (module docstring). ``rows`` and
    ``max_segments`` may round up past the plan's own (shape bucketing);
    the extra rows and slots are all padding."""
    k = int(num_cls_tokens)
    r = plan.rows if rows is None else int(rows)
    smax = plan.max_segments if max_segments is None else int(max_segments)
    if r < plan.rows or smax < plan.max_segments:
        raise ValueError(
            f"plan needs rows>={plan.rows}, max_segments>={plan.max_segments}; got rows={r}, max_segments={smax}"
        )
    seg = np.zeros((r, plan.budget), np.int32)
    cls_pos = np.full((r, plan.budget), -1, np.int32)
    cls_index = np.zeros((r, smax, k), np.int32)
    for s in plan.segments:
        seg[s.row, s.offset : s.offset + s.length] = s.slot + 1
        cls_pos[s.row, s.offset : s.offset + k] = np.arange(k, dtype=np.int32)
        cls_index[s.row, s.slot] = s.offset + np.arange(k, dtype=np.int32)
    return {"segment_ids": seg, "cls_pos": cls_pos, "cls_index": cls_index}


def place_tokens(
    plan: PackPlan, patch_tokens, num_cls_tokens: int, *, rows: int | None = None, dtype=np.float32
) -> np.ndarray:
    """Scatter each request's ``(length - k, dim)`` patch tokens into the
    packed ``(rows, budget, dim)`` host buffer; CLS slots and padding stay
    zero (the encoder writes its CLS parameter on the device)."""
    k = int(num_cls_tokens)
    r = plan.rows if rows is None else int(rows)
    dim = int(np.shape(patch_tokens[0])[-1])
    buf = np.zeros((r, plan.budget, dim), dtype)
    for s in plan.segments:
        toks = np.asarray(patch_tokens[s.request], dtype)
        if toks.shape[0] != s.length - k:
            raise ValueError(f"request {s.request}: planned {s.length - k} patch tokens, got {toks.shape[0]}")
        buf[s.row, s.offset + k : s.offset + s.length] = toks
    return buf


def unpack_rows(plan: PackPlan, packed_out) -> list[np.ndarray]:
    """Each request's per-segment output from a ``(rows, max_segments,
    ...)`` result, in request order."""
    out: list = [None] * len(plan.segments)
    for s in plan.segments:
        out[s.request] = np.asarray(packed_out[s.row, s.slot])
    return out
