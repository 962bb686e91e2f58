"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``, refusing CUDA when absent.

    The port serves on the GPU. Asking for ``"cuda"`` on a machine without
    a CUDA device raises ``RuntimeError`` rather than carrying on quietly on
    the CPU; the CPU runs only when the caller names it (the tests do).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
