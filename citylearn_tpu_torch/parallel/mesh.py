"""The district mesh: district batches sharded over GPUs, one process per
GPU under ``torch.distributed``.

The port of ``citylearn_tpu/parallel/mesh.py``. The workload's
parallelism is data parallelism over the district batch: each rank holds
``n_districts / world_size`` districts on its own card, runs its own
share-nothing kernel launches on them, and holds a replica of the
input series and of the learners. Where JAX partitions one program over a
``dp`` mesh axis, here each process runs its share and the few
cross-rank exchanges are explicit collectives, all issued through this
module's :func:`all_reduce`, :func:`all_gather` and :func:`broadcast`,
which count them on the mesh (``DistrictMesh.collectives``): a sharded
whole-episode evaluation issues none.

Start one process per GPU, as ``torchrun`` does::

    torchrun --nproc-per-node 4 my_script.py

and in each::

    initialize_distributed()            # reads torchrun's environment
    mesh = district_mesh()              # cuda:$LOCAL_RANK
    table = evaluate_scripted(cfg, params, policy, n_districts=4096, mesh=mesh)
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import List, Optional

import torch
import torch.distributed as dist

from citylearn_tpu_torch.core.types import map_tensors


def free_port() -> int:
    """A TCP port of this machine that is free now: the ``MASTER_PORT``
    (or the ``tcp://localhost:<port>``) of ranks that one process starts on
    its own machine."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process group: a no-op at a world size of 1 or less.

    ``world_size`` and ``rank`` default to ``torchrun``'s ``WORLD_SIZE``
    and ``RANK``, ``init_method`` to ``env://`` (its ``MASTER_ADDR`` and
    ``MASTER_PORT``); pass ``tcp://host:port`` where nothing sets those.
    ``backend`` defaults to ``nccl`` where a CUDA card is present, as the
    entry points default to the card, and to ``gloo`` where none is; a
    CPU mesh on a machine with a card passes ``backend="gloo"``."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return
    if rank is None:
        if "RANK" not in os.environ:
            raise ValueError("initialize_distributed needs rank= (or RANK in the environment)")
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=int(world_size), rank=int(rank))


@dataclasses.dataclass
class DistrictMesh:
    """One rank's place in the district mesh. ``group`` is ``None`` when no
    process group is up (a world of one, in which nothing is exchanged);
    ``collectives`` counts the collectives issued through this module."""
    rank: int
    world_size: int
    device: torch.device
    group: Optional[object]
    collectives: int = 0


def _mesh_device(device) -> torch.device:
    """``device``, a CUDA device with its index (``cuda:$LOCAL_RANK`` by
    default) made current; raises when that card is absent."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' for a CPU mesh")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"the mesh's device {dev} is absent: this process sees "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"a district mesh runs on CUDA or CPU devices, not {dev}")
    return dev


def district_mesh(n_devices: Optional[int] = None, device=None) -> Optional[DistrictMesh]:
    """This rank's district mesh: over every rank of the process group,
    or its first ``n_devices`` ranks; a world of one when no process group
    is up. Every rank must call it (a subgroup is made collectively); a
    rank outside the first ``n_devices`` gets ``None``.

    ``device`` defaults to ``cuda:$LOCAL_RANK``, which becomes the current
    CUDA device; ``device="cpu"`` makes a CPU mesh (the ``gloo`` backend)."""
    if not dist.is_initialized():
        if n_devices is not None and n_devices != 1:
            raise ValueError(f"a mesh of {n_devices} devices needs a process group of as many "
                             "ranks: call initialize_distributed first")
        return DistrictMesh(0, 1, _mesh_device(device), None)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    dev = _mesh_device(device)
    if dev.type == "cpu" and dist.get_backend(group) == "nccl":
        raise ValueError("the nccl backend exchanges CUDA tensors only: a CPU mesh needs gloo")
    return DistrictMesh(rank, n, dev, group)


def district_slice(mesh: DistrictMesh, n_districts: int) -> slice:
    """This rank's rows of a global batch of ``n_districts``: an equal
    share for every rank."""
    if n_districts % mesh.world_size:
        raise ValueError(f"n_districts={n_districts} does not split evenly over "
                         f"{mesh.world_size} ranks")
    n = n_districts // mesh.world_size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_district_batch(mesh: DistrictMesh, env_state, params):
    """This rank's rows of a (D, ...) district state, on the mesh's
    device, and the district parameters there (replicated)."""
    rows = district_slice(mesh, int(env_state.t.shape[0]))
    return (map_tensors(lambda x: x[rows].to(mesh.device), env_state),
            params.to(mesh.device))


def all_reduce(mesh: DistrictMesh, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced in place over the mesh (returned for convenience)."""
    if mesh.group is not None:
        mesh.collectives += 1
        dist.all_reduce(x, op=op, group=mesh.group)
    return x


def all_gather(mesh: DistrictMesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``x``, in rank order (each rank's ``x`` of one shape)."""
    if mesh.group is None:
        return [x]
    mesh.collectives += 1
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(out, x, group=mesh.group)
    return out


def broadcast(mesh: DistrictMesh, x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``x`` overwritten in place by rank ``src``'s (returned for convenience)."""
    if mesh.group is not None:
        mesh.collectives += 1
        dist.broadcast(x, src=src, group=mesh.group)
    return x


def gather_districts(mesh: DistrictMesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global batch from every rank's share of it along the district
    axis ``dim`` (every share of one size). A tensor with no elements (a
    district without EVs holds (D, 0) EV state) needs no exchange."""
    if mesh.group is None:
        return x
    if x.numel() == 0:
        shape = list(x.shape)
        shape[dim] *= mesh.world_size
        return x.new_empty(shape)
    parts = all_gather(mesh, x.movedim(dim, 0))
    return torch.cat(parts).movedim(0, dim)
