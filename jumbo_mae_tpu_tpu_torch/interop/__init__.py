"""Weight bridges into the port."""

from jumbo_mae_tpu_tpu_torch.interop.from_jax import state_dict_from_jax

__all__ = ["state_dict_from_jax"]
