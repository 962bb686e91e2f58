"""Weight bridges into the port."""

from jumbo_mae_tpu_tpu_torch.interop.from_jax import mae_state_dict_from_jax, state_dict_from_jax

__all__ = ["mae_state_dict_from_jax", "state_dict_from_jax"]
