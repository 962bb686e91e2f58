"""The port's training runtime; each module mirrors ``jumbo_mae_tpu_tpu/train``."""
