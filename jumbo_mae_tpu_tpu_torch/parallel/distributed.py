"""Multi-process training: the rendezvous, the backend rule and the
collectives of host values.

Counterpart of the JAX driver's ``jax.distributed.initialize`` and its
``multihost_utils.process_allgather`` (``jumbo_mae_tpu_tpu/cli/train.py``).
A process finds the others in one of two ways:

- ``--coordinator HOST:PORT --num-processes N --process-id I``: the
  process group meets at ``tcp://HOST:PORT``, where process 0 listens;
- torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), in place of the
  JAX driver's auto-detection on a TPU pod.

Each process drives ``cuda:{LOCAL_RANK % cards}`` (or the CPU). The
backend is a rule, not a fallback (:func:`backend_for`): ``gloo`` on the
CPU or where a node runs more processes than it has cards (two ranks
sharing one card cannot each own an NCCL communicator on it), ``nccl``
otherwise. Nothing retries on another backend. The host values the
driver agrees on (the data cursors, the preemption flag, the eval sums)
cross a collective on the CPU under gloo and on the rank's card under
nccl (:func:`staging_device`), each staged there explicitly.
"""

from __future__ import annotations

import ipaddress
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

NO_RENDEZVOUS = (
    "--distributed needs a rendezvous: pass --coordinator HOST:PORT with --num-processes N and --process-id I, "
    "or launch under torchrun, which sets RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK"
)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class Rendezvous:
    """Where and as what this process joins the group."""

    init_method: str
    world_size: int
    rank: int
    local_rank: int
    local_world_size: int  # the processes on this node


def _loopback(host: str) -> bool:
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host.strip("[]")).is_loopback
    except ValueError:
        return False


def rendezvous(coordinator: str | None = None, num_processes: int | None = None, process_id: int | None = None,
               env=None) -> Rendezvous:
    """The rendezvous of ``--coordinator`` (with ``--num-processes`` and
    ``--process-id``), else of torchrun's environment; neither raises
    ``ValueError`` naming both. Under ``--coordinator`` the node's process
    count is ``LOCAL_WORLD_SIZE`` where set, else all of them for a
    loopback coordinator (every process on this machine) and 1 otherwise;
    the local rank is ``LOCAL_RANK`` where set, else the process id
    modulo that count."""
    env = os.environ if env is None else env
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"--process-id {process_id} is not in [0, {num_processes})")
        host = coordinator.rsplit(":", 1)[0]
        local = int(env.get("LOCAL_WORLD_SIZE", num_processes if _loopback(host) else 1))
        return Rendezvous(f"tcp://{coordinator}", num_processes, process_id,
                          int(env.get("LOCAL_RANK", process_id % local)), local)
    if all(k in env for k in TORCHRUN_ENV):
        return Rendezvous("env://", int(env["WORLD_SIZE"]), int(env["RANK"]), int(env.get("LOCAL_RANK", 0)),
                          int(env.get("LOCAL_WORLD_SIZE", 1)))
    raise ValueError(NO_RENDEZVOUS)


def backend_for(device_type: str, local_processes: int, local_devices: int) -> str:
    """``gloo`` on the CPU, or where the node runs more processes than it
    has cards; ``nccl`` otherwise."""
    if device_type == "cpu" or local_processes > local_devices:
        return "gloo"
    return "nccl"


def init_distributed(rdv: Rendezvous, device: str = "cuda") -> tuple[torch.device, str]:
    """Join the process group of ``rdv``; returns this process's device
    (``cuda:{local_rank % cards}``, or the CPU when ``device`` names it)
    and the backend :func:`backend_for` chose."""
    kind = torch.device(device).type
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU explicitly")
        dev = torch.device("cuda", rdv.local_rank % cards)
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        cards, dev = 0, torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    backend = backend_for(dev.type, rdv.local_world_size, cards)
    dist.init_process_group(backend, init_method=rdv.init_method, world_size=rdv.world_size, rank=rdv.rank)
    return dev, backend


def process_topology() -> tuple[int, int]:
    """``(process_count, process_index)``: ``(1, 0)`` outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def staging_device() -> torch.device:
    """Where a host value crosses a collective: the CPU under gloo, this
    rank's card under nccl (which takes CUDA tensors only)."""
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def all_gather_host(values, dtype=np.int64) -> np.ndarray:
    """Every process's ``values`` (one shape on all of them), stacked on a
    new first axis in rank order. Collective."""
    t = torch.from_numpy(np.array(values, dtype=dtype)).to(staging_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def all_reduce_host(values, op: str = "sum", dtype=np.float64) -> np.ndarray:
    """``values`` summed (``op="sum"``) or maxed (``"max"``) over every
    process. Collective."""
    t = torch.from_numpy(np.array(values, dtype=dtype)).to(staging_device())
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
    return t.cpu().numpy()


def barrier() -> None:
    """Every process of the group reaches here before any goes on."""
    if staging_device().type == "cuda":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
