"""Resilience layer: deterministic fault injection.

Counterpart of ``jumbo_mae_tpu_tpu/faults``: ``faults.inject`` holds the
named fault sites driven by a seeded plan (the ``GRAFT_FAULTS`` env var;
a no-op when unset). The divergence sentinel (``faults/sentinel.py``) is
still to port with the training layers (ROADMAP A7).
"""

from jumbo_mae_tpu_tpu_torch.faults.inject import (
    KNOWN_SITES,
    FaultPlan,
    FaultRule,
    active_plan,
    clear_plan,
    current_host_index,
    fault_point,
    faults_active,
    install_plan,
    set_host_index,
)

__all__ = [
    "KNOWN_SITES",
    "FaultPlan",
    "FaultRule",
    "active_plan",
    "clear_plan",
    "current_host_index",
    "fault_point",
    "faults_active",
    "install_plan",
    "set_host_index",
]
