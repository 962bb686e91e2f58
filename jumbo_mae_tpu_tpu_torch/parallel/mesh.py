"""The device mesh: its configuration, construction and the ambient mesh.

Counterpart of ``jumbo_mae_tpu_tpu/parallel/mesh.py`` and of the ambient
mesh of ``utils/compat.py:18-60``. The axes are the JAX package's,
``(data, fsdp, tensor, seq)``:

- ``data`` — batch sharding: each data rank takes its rows of the global
  batch, and the train step averages the gradients over the data group;
- ``seq`` — sequence parallelism for ring attention
  (``parallel/ring_attention.py``). Each seq rank holds the whole
  sequence's activations, as GSPMD presents them outside ``shard_map``;
  attention takes its chunk and rotates K/V around the ring;
- ``fsdp``, ``tensor`` and ``pipe`` above 1 are not ported yet (ROADMAP
  A6.3, A6.4, A6.5) and raise.

Under ``torch.distributed`` the mesh is a ``DeviceMesh`` over the four
axes, one process per device, and the ``seq`` ring runs over the ``seq``
subgroup. ``one_process_seq=True`` instead holds the whole ``seq`` axis
in each process, its shards stacked on the batch axis of one device
(``StackedRing``): the only ring of more than one shard a one-card
machine can run. The caller chooses it; nothing falls back to it.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from collections.abc import Iterator
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device

AXES = ("data", "fsdp", "tensor", "seq")

NOT_PORTED = (
    "mesh {axes} > 1 is not ported yet: ROADMAP queue {items}; the port "
    "shards 'data' and 'seq' (over several processes, set mesh.data to "
    "their count)"
)
# the ROADMAP item of each axis the port refuses
AXIS_ITEMS = {"fsdp": "A6.3 (FSDP2 for 'fsdp')", "tensor": "A6.4 (tensor parallelism)",
              "pipe": "A6.5 (the GPipe pipeline)"}


@dataclass(frozen=True)
class MeshConfig:
    """Axis sizes; -1 on ``fsdp`` means "all remaining devices". The same
    fields, defaults and arithmetic as the JAX package's ``MeshConfig``."""

    data: int = 1
    fsdp: int = -1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1
    pipe_microbatches: int = 0  # 0 → defaults to the pipe size
    # pretrain only: also depth-shard the MAE decoder stack over ``pipe``
    pipe_decoder: bool = False

    def validate_pipe(self) -> None:
        if self.pipe > 1 and any(s not in (1, -1) for s in (self.fsdp, self.tensor, self.seq)):
            raise ValueError(
                "mesh.pipe composes with mesh.data only; set fsdp/tensor/seq "
                "to 1 (pipeline + FSDP/TP/SP composition is not wired)"
            )

    def resolve(self, n_devices: int) -> tuple[int, int, int, int]:
        if self.pipe > 1:
            raise ValueError(
                "MeshConfig.pipe > 1 selects pipeline parallelism — build "
                "the mesh with create_pipeline_mesh, not create_mesh/resolve"
            )
        sizes = [self.data, self.fsdp, self.tensor, self.seq]
        if sizes.count(-1) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = math.prod(s for s in sizes if s != -1)
        if -1 in sizes:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {known}")
            sizes[sizes.index(-1)] = n_devices // known
        if math.prod(sizes) > n_devices:
            raise ValueError(
                f"mesh {dict(zip(AXES, sizes))} needs more than the "
                f"{n_devices} available devices"
            )
        return tuple(sizes)  # type: ignore[return-value]


@dataclass(frozen=True)
class Mesh:
    """A resolved mesh: axis sizes and the process subgroups of the
    ``data`` and ``seq`` axes (none where this process holds the whole
    axis). Build it with :func:`create_mesh`."""

    shape: dict[str, int]
    one_process_seq: bool = False
    groups: dict[str, object] = field(default_factory=dict)

    def group(self, axis: str):
        """The process group of ``axis``, or ``None`` when this process
        holds the whole axis."""
        return self.groups.get(axis)

    @property
    def data_size(self) -> int:
        return self.shape["data"]

    @property
    def data_rank(self) -> int:
        g = self.group("data")
        return 0 if g is None else dist.get_rank(g)


def _refuse_unported(sizes: dict[str, int]) -> None:
    unported = [a for a in ("fsdp", "tensor", "pipe") if sizes.get(a, 1) > 1]
    if unported:
        raise NotImplementedError(NOT_PORTED.format(axes=" and ".join(repr(a) for a in unported),
                                                    items=", ".join(AXIS_ITEMS[a] for a in unported)))


def create_mesh(
    config: MeshConfig | None = None,
    *,
    device: str | torch.device = "cuda",
    one_process_seq: bool = False,
) -> Mesh:
    """Build the mesh for this process.

    Without ``torch.distributed`` this process is the one device, so only
    a mesh of size 1 resolves — unless ``one_process_seq`` holds the
    ``seq`` axis in this process. Under ``torch.distributed`` every rank of
    the default group is one device of a ``DeviceMesh`` over
    ``(data, fsdp, tensor, seq)``, and the mesh must use all of them.
    ``fsdp``, ``tensor`` or ``pipe`` above 1 raise ``NotImplementedError``
    (ROADMAP A6)."""
    config = config or MeshConfig()
    config.validate_pipe()
    _refuse_unported({"pipe": config.pipe, "fsdp": config.fsdp, "tensor": config.tensor})
    if one_process_seq and config.seq < 1:
        raise ValueError("one_process_seq needs an explicit seq size")
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    n_devices = world * config.seq if one_process_seq else world
    sizes = dict(zip(AXES, config.resolve(n_devices)))
    _refuse_unported(sizes)  # an fsdp of -1 may take the remaining devices
    per_process = dict(sizes, seq=1) if one_process_seq else sizes
    if world > 1:
        if math.prod(per_process.values()) != world:
            raise ValueError(
                f"mesh {sizes} does not use the {world} processes of the default group"
            )
        from torch.distributed.device_mesh import init_device_mesh

        # gloo's collectives run on the host: its mesh is a CPU mesh, whatever
        # device the ranks compute on
        mesh_type = "cpu" if dist.get_backend() == "gloo" else dev.type
        dm = init_device_mesh(mesh_type, tuple(per_process.values()), mesh_dim_names=AXES)
        groups = {a: dm.get_group(a) for a in ("data", "seq") if per_process[a] > 1}
        return Mesh(sizes, one_process_seq, groups)
    return Mesh(sizes, one_process_seq)


_AMBIENT: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar("ambient_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh: Mesh | None) -> Iterator[Mesh | None]:
    """Make ``mesh`` the ambient mesh inside the ``with`` block (the
    counterpart of ``compat.set_mesh``). Model code reads it through
    :func:`ambient_mesh`; the train step runs under it."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def ambient_mesh() -> Mesh | None:
    """The mesh of the innermost :func:`set_mesh` of this thread's context,
    or ``None``. A thread starts with none (PyTorch runs a CUDA backward on
    threads of its own), so code that runs again in the backward — a
    gradient-checkpoint recompute — carries the mesh it saw forward."""
    return _AMBIENT.get()


def batch_rand(shape: tuple[int, ...], *, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform draws for this data rank's rows of the global batch.

    ``shape[0]`` is the local batch. The draw covers the global batch
    (``data`` × local rows) from ``generator``, and the rank keeps its
    slice, so every data rank draws from one stream and a run on ``data``
    ranks equals one process on the global batch. Every seq rank draws the
    same values."""
    mesh = ambient_mesh()
    n, r = (1, 0) if mesh is None else (mesh.data_size, mesh.data_rank)
    u = torch.rand((shape[0] * n, *shape[1:]), generator=generator, device=device)
    return u[r * shape[0] : (r + 1) * shape[0]]
