"""Process-group bring-up, pair-parallel inference and Gaussian-sharded
splat state on torch.distributed (port of
`starst3r_tpu/parallel/distributed.py`).

One process per rank (`torchrun --nproc-per-node N`, or processes started
by hand with an address, a world size and a rank). `initialize_distributed`
makes the default process group with the backend the caller names: NCCL
for the card, gloo for the CPU. It never swaps one backend for another; two
ranks on one card under NCCL raise. A `GSState` sharded by
`shard_gs_state` holds, on rank r of the axis, rows [r N/W, (r+1) N/W) of
every Gaussian parameter and Adam moment; its step, alive count and
generator are rank 0's on every rank.
"""

from __future__ import annotations

import os
import socket
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .comm import all_gather_rows, broadcast
from .mesh import (NamedSharding, P, axis_group, axis_names, axis_rank,
                   axis_size)

__all__ = ("initialize_distributed", "pair_sharding", "replicate",
           "shard_gs_state", "gather_gs_state", "GaussShard")


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None, device="cuda",
                           local_rank: Optional[int] = None) -> None:
    """Make the default process group (a no-op when one exists with this
    backend; another backend raises).

    ``coordinator``: "host:port" (tcp) or an init-method URL ("tcp://...",
    "file:///path/store"), with ``num_processes`` and ``process_id``.
    Without it, the `torchrun` variables (RANK, WORLD_SIZE, MASTER_ADDR)
    are read when all are set; else the group is one process of world size
    1 on an in-process store, so a mesh exists in one process. ``backend``
    defaults to "nccl" for ``device`` "cuda" (the card; raises without one)
    and "gloo" for "cpu". On the card each process takes device
    ``local_rank`` (LOCAL_RANK, else the rank) modulo the device count; one
    process alone keeps ``device``."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"a {dist.get_backend()} process group exists; "
                f"{backend} was asked for")
        return
    env = os.environ
    init_method = None
    if coordinator is not None:
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
        if num_processes is None or process_id is None:
            raise ValueError("coordinator needs num_processes and "
                             "process_id")
        rank, world = int(process_id), int(num_processes)
    elif all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        init_method = "env://"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        if local_rank is None and "LOCAL_RANK" in env:
            local_rank = int(env["LOCAL_RANK"])
    else:
        rank, world = 0, 1
    if dev.type == "cuda" and (init_method or local_rank is not None):
        idx = (rank if local_rank is None else local_rank) \
            % torch.cuda.device_count()
        dev = torch.device("cuda", idx)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    if backend == "nccl" and world > 1:
        _check_one_rank_per_card(dev)


def _check_one_rank_per_card(dev: torch.device) -> None:
    """NCCL runs one rank per card: ranks that share one raise here, before
    any collective, rather than at NCCL's first communicator."""
    probe = dist.new_group(backend="gloo")
    props = torch.cuda.get_device_properties(dev)
    mine = (socket.gethostname(), str(getattr(props, "uuid", dev.index)))
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, mine, group=probe)
    dist.destroy_process_group(probe)
    dup = [r for r, who in enumerate(seen) if who == mine]
    if len(dup) > 1:
        dist.destroy_process_group()
        raise RuntimeError(
            f"NCCL runs one rank per card, but ranks {dup} share {dev} on "
            f"{mine[0]}; start one process per card or pass backend='gloo'")


def pair_sharding(mesh, axis: Optional[str] = None) -> NamedSharding:
    """The sharding of a (B, H, W, 3) pair batch: the batch split along the
    data axis (pair-parallel inference)."""
    return NamedSharding(mesh, P(axis or axis_names(mesh)[0]))


def replicate(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


class GaussShard(NamedTuple):
    """Where a sharded `GSState`'s rows sit: rows [lo, hi) of ``n`` on
    ``rank`` of the ``size`` ranks along mesh ``axis``."""

    mesh: object
    axis: str
    n: int
    lo: int
    hi: int
    rank: int
    size: int

    @property
    def group(self):
        return axis_group(self.mesh, self.axis)


def shard_gs_state(state, mesh, axis: Optional[str] = None):
    """This rank's shard of a `GSState`: rows [r N/W, (r+1) N/W) of every
    parameter and of every Adam moment with N rows, for rank r of W along
    ``axis`` (the mesh's first by default); step, alive count and generator
    state broadcast from rank 0. N must divide by W, as the JAX package's
    ``device_put`` requires."""
    axis = axis or axis_names(mesh)[0]
    w, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    n = next(iter(state.params.values())).shape[0]
    if n % w:
        raise ValueError(
            f"the Gaussian pool's dimension 0 should be divisible by {w} "
            f"(mesh axis {axis!r}), but it is equal to {n}")
    lo, hi = r * n // w, (r + 1) * n // w

    def rows(x):
        return x[lo:hi].clone() if x.dim() >= 1 and x.shape[0] == n else x

    dev = next(iter(state.params.values())).device
    step, n_alive = (int(v) for v in broadcast(
        torch.tensor([state.step, state.n_alive], dtype=torch.long),
        dist.group.WORLD).tolist())
    gen_state = broadcast(state.generator.get_state(), dist.group.WORLD)
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    opt = state.opt_state
    return state._replace(
        params={k: rows(v) for k, v in state.params.items()},
        opt_state=opt._replace(mu={k: rows(v) for k, v in opt.mu.items()},
                               nu={k: rows(v) for k, v in opt.nu.items()}),
        step=step, n_alive=n_alive, generator=gen,
        shard=GaussShard(mesh, axis, n, lo, hi, r, w))


def gather_gs_state(state):
    """The whole `GSState` on every rank from a sharded one (unchanged when
    it is not sharded)."""
    sh = state.shard
    if sh is None:
        return state
    g = sh.group
    full = lambda d: {k: all_gather_rows(v, g) for k, v in d.items()}
    opt = state.opt_state
    return state._replace(params=full(state.params),
                          opt_state=opt._replace(mu=full(opt.mu),
                                                 nu=full(opt.nu)),
                          shard=None)
