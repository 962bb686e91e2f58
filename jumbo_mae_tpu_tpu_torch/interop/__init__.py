"""Weight bridges into the port."""

from jumbo_mae_tpu_tpu_torch.interop.from_jax import (
    classifier_state_dict_from_jax,
    flax_path,
    mae_state_dict_from_jax,
    state_dict_from_jax,
)

__all__ = ["classifier_state_dict_from_jax", "flax_path", "mae_state_dict_from_jax", "state_dict_from_jax"]
