"""Shared helpers for the offline doctors.

Counterpart of ``jumbo_mae_tpu_tpu/obs/doctor_common.py``; the port's
``tools/{batch,cost,serve,mem}_doctor.py`` use it, and the run doctor
will (ROADMAP A7). A doctor turns a crash-safe JSONL artifact (the run
journal, the serving access log) into a markdown diagnosis, and each
needs the same primitives:
number formatting that tolerates the journal's ``"nan"``/``"inf"`` string
encoding, merging sorted indices into contiguous windows, and naming those
windows the way an operator reads them ("steps 5–7", "requests 24–39").
Kept here so the reports stay consistent instead of drifting as
copy-pastes.
"""

from __future__ import annotations

from pathlib import Path


def fmt_num(v, nd: int = 4) -> str:
    """Compact human formatting: ints stay ints, floats get ``nd``
    significant digits, the journal's stringified non-finites pass through."""
    if isinstance(v, (int, float)):
        try:
            f = float(v)
        except (TypeError, ValueError):
            return str(v)
        if f != f or f in (float("inf"), float("-inf")):
            return str(f)
        if isinstance(v, int) or f.is_integer():
            return str(int(f))
        return f"{f:.{nd}g}"
    return str(v)


def contiguous_windows(indices) -> list[tuple[int, int]]:
    """Merge an iterable of ints into sorted inclusive ``(lo, hi)`` runs:
    ``{5, 6, 7, 12}`` → ``[(5, 7), (12, 12)]``."""
    windows: list[tuple[int, int]] = []
    for s in sorted(set(int(i) for i in indices)):
        if windows and s == windows[-1][1] + 1:
            windows[-1] = (windows[-1][0], s)
        else:
            windows.append((s, s))
    return windows


def spans_text(windows: list[tuple[int, int]], noun: str = "step") -> str:
    """Operator-readable window naming: ``[(5, 7), (12, 12)]`` with noun
    ``"step"`` → ``"steps 5–7, step 12"``."""
    return ", ".join(
        f"{noun}s {a}–{b}" if a != b else f"{noun} {a}" for a, b in windows
    )


def write_report(markdown: str, out: str | None, *, tool: str) -> int:
    """Land the diagnosis: write to ``out`` (creating parents) or print to
    stdout. Returns the success exit code (0) so ``main`` can tail-call."""
    if out:
        p = Path(out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(markdown)
        print(f"[{tool}] diagnosis -> {out}")
    else:
        print(markdown)
    return 0
