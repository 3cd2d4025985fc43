"""Device meshes over torch.distributed (port of
`starst3r_tpu/parallel/mesh.py`).

The JAX package is single-controller: it annotates shardings on a `Mesh` and
XLA inserts the collectives. PyTorch runs one process per rank, so here a
mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, with named dims; each dim has its own process group,
and the port's code runs the collectives along it itself
(`parallel/comm.py`). A `NamedSharding` is a plain description, a mesh and
a `P` spec with one mesh axis (or None) per tensor dim, that the sharded
code paths read to decide which rows a rank holds; nothing moves a tensor
implicitly.

Axes (see config.MeshConfig):
  data  — pair-parallel inference, camera splits, correspondence and track
          shards, Gaussian shards in splat training
  model — tensor parallelism of the ViT (`parallel/tp.py`)

A mesh covers every rank of the process group: a rank outside it would
still run the program and meet collectives it takes no part in (the JAX
package may leave devices out of a mesh; one process drives them all).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ("make_mesh", "replicated", "shard_along", "local_mesh", "P",
           "NamedSharding", "axis_names", "axis_size", "axis_rank",
           "axis_group")


class P(tuple):
    """A partition spec: per tensor dim, the mesh axis it is split along,
    or None (replicated). ``P()`` replicates every dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclass(frozen=True)
class NamedSharding:
    mesh: DeviceMesh
    spec: P


def _mesh_over(ranks: Sequence[int], shape, names) -> DeviceMesh:
    world = dist.get_world_size()
    if sorted(ranks) != list(range(world)):
        raise ValueError(
            f"a mesh of shape {tuple(shape)} over ranks {list(ranks)} does "
            f"not cover the {world} ranks of the process group")
    # the mesh's device type names where its collectives run: the card
    # under NCCL, the host under gloo (whatever device the ranks compute on)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(list(ranks)).reshape(shape),
                      mesh_dim_names=tuple(names))


def make_mesh(data: int = 0, model: int = 1,
              devices: Optional[Sequence[int]] = None,
              data_axis: str = "data", model_axis: str = "model"
              ) -> DeviceMesh:
    """A 2-D (data, model) mesh over the process group's ranks (``devices``:
    the ranks in mesh order, all of them). data=0 means "all remaining
    ranks". Without a process group, `initialize_distributed()` sets up one
    of world size 1 on the card."""
    from .distributed import initialize_distributed
    if not dist.is_initialized():
        initialize_distributed()
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    n = len(ranks)
    if data <= 0:
        assert n % model == 0, (n, model)
        data = n // model
    assert data * model <= n, (data, model, n)
    return _mesh_over(ranks[: data * model], (data, model),
                      (data_axis, model_axis))


def local_mesh(axis: str = "data") -> DeviceMesh:
    """1-D mesh over every rank."""
    from .distributed import initialize_distributed
    if not dist.is_initialized():
        initialize_distributed()
    world = dist.get_world_size()
    return _mesh_over(list(range(world)), (world,), (axis,))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_along(mesh: DeviceMesh, axis_name: str, ndim: int = 1,
                dim: int = 0) -> NamedSharding:
    """A sharding that splits tensor dim ``dim`` along mesh axis
    ``axis_name`` and replicates everything else."""
    spec = [None] * ndim
    spec[dim] = axis_name
    return NamedSharding(mesh, P(*spec))


def axis_names(mesh: DeviceMesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.size(axis_names(mesh).index(axis)))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)
