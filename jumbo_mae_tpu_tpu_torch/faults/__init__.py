"""Resilience layer: deterministic fault injection and the divergence sentinel.

Counterpart of ``jumbo_mae_tpu_tpu/faults``: ``faults.inject`` holds the
named fault sites driven by a seeded plan (the ``GRAFT_FAULTS`` env var or
``run.faults``; a no-op when unset) and the ``host.leak`` ballast;
``faults.sentinel`` holds the host half of the divergence sentinel, whose
device half is the train step's guard (``train/steps.py``).
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
    host_leak_tick,
    install_plan,
    leak_ballast_bytes,
    set_host_index,
)
from jumbo_mae_tpu_tpu_torch.faults.sentinel import DivergenceError, DivergenceSentinel, SentinelConfig

__all__ = [
    "KNOWN_SITES",
    "DivergenceError",
    "DivergenceSentinel",
    "FaultPlan",
    "FaultRule",
    "SentinelConfig",
    "active_plan",
    "clear_plan",
    "current_host_index",
    "fault_point",
    "faults_active",
    "host_leak_tick",
    "install_plan",
    "leak_ballast_bytes",
    "set_host_index",
]
