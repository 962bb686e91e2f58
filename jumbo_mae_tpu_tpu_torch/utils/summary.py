"""Parameter-count summary printed at startup.

Counterpart of ``jumbo_mae_tpu_tpu/utils/summary.py``: a per-subtree
parameter table (down to ``depth`` levels of the dotted parameter names)
and the totals, walked over the model's real ``named_parameters``.
"""

from __future__ import annotations

from torch import nn


def _fmt_count(n: int) -> str:
    for unit, div in (("B", 1e9), ("M", 1e6), ("K", 1e3)):
        if n >= div:
            return f"{n / div:,.2f}{unit}"
    return str(n)


def param_summary(model: nn.Module, *, depth: int = 2) -> str:
    """Render the table, e.g.::

        encoder.blocks             302.31M
        ...
        total                      329.54M params (1.23 GiB)
    """
    rows: dict[str, int] = {}
    total_n = total_b = 0
    for name, p in model.named_parameters():
        group = ".".join(name.split(".")[:depth])
        rows[group] = rows.get(group, 0) + p.numel()
        total_n += p.numel()
        total_b += p.numel() * p.element_size()
    width = max((len(name) for name in rows), default=10) + 2
    lines = [f"{name:<{width}} {_fmt_count(n):>10}" for name, n in rows.items()]
    lines.append(f"{'total':<{width}} {_fmt_count(total_n):>10} params ({total_b / 2**30:.2f} GiB)")
    return "\n".join(lines)
