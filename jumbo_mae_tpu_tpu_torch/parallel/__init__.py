"""Data and sequence parallelism: the mesh and ring attention."""

from jumbo_mae_tpu_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshConfig,
    ambient_mesh,
    create_mesh,
    set_mesh,
)
from jumbo_mae_tpu_tpu_torch.parallel.ring_attention import (
    ProcessGroupRing,
    StackedRing,
    ring_attention,
    ring_attention_sharded,
    ring_self_attention,
)

__all__ = [
    "AXES",
    "Mesh",
    "MeshConfig",
    "ProcessGroupRing",
    "StackedRing",
    "ambient_mesh",
    "create_mesh",
    "ring_attention",
    "ring_attention_sharded",
    "ring_self_attention",
    "set_mesh",
]
