"""The port's observability; each module mirrors ``jumbo_mae_tpu_tpu/obs``."""
