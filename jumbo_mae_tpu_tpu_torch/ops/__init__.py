"""Numerics ops of the port; each module mirrors ``jumbo_mae_tpu_tpu/ops``."""
