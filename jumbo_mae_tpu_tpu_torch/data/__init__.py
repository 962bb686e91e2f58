"""The port's data sources; each module mirrors ``jumbo_mae_tpu_tpu/data``."""
