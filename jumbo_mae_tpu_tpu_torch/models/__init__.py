"""The port's models; each module mirrors ``jumbo_mae_tpu_tpu/models``."""

from jumbo_mae_tpu_tpu_torch.models.config import JumboViTConfig, PRESETS, preset
from jumbo_mae_tpu_tpu_torch.models.vit import JumboViT, pool_tokens

__all__ = ["JumboViTConfig", "PRESETS", "preset", "JumboViT", "pool_tokens"]
