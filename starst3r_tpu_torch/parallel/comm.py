"""The collectives of the port's sharded paths, on torch.distributed.

Each helper returns its result on the device of its input. Where a tensor
lives is decided against the group's backend, never by trying: NCCL takes
tensors on the card; gloo is given host tensors, so a CUDA tensor goes
through the host for a gloo group (two ranks sharing one card can only
talk over gloo, since NCCL refuses two ranks on one device). Nothing is
caught and retried another way.

`AllGatherRows` is the all-gather of row shards with autograd: its backward
reduce-scatters (sums) the gradient of the gathered rows back to their
owners.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ("all_reduce", "broadcast", "broadcast_object", "all_gather_rows",
           "reduce_scatter_rows", "AllGatherRows")


def _comm_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@contextlib.contextmanager
def _deprecated_ok():
    # torch 2.13 marks all_gather_into_tensor / reduce_scatter_tensor as
    # deprecated in favour of names older releases lack
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


def all_reduce(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` (identical on every
    rank)."""
    buf = x.detach().to(_comm_device(group), copy=True).contiguous()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def broadcast(x: torch.Tensor, group=None, src: int = 0) -> torch.Tensor:
    """A new tensor: group rank ``src``'s ``x`` on every rank."""
    buf = x.detach().to(_comm_device(group), copy=True).contiguous()
    dist.broadcast(buf, src=dist.get_global_rank(group or dist.group.WORLD,
                                                 src), group=group)
    return buf.to(x.device)


def _map_tensors(obj: Any, fn) -> Any:
    """``obj`` with ``fn`` applied to every tensor in its dataclasses,
    named tuples, tuples, lists and dicts."""
    import dataclasses
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(v, fn) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


def broadcast_object(obj: Any, device: torch.device, group=None,
                     src: int = 0) -> Any:
    """Group rank ``src``'s ``obj`` (any picklable structure of numpy
    arrays, tensors, dataclasses and tuples) on every rank, its tensors on
    ``device``. Other ranks' ``obj`` is ignored."""
    rank = dist.get_rank(group)
    box = [_map_tensors(obj, lambda t: t.detach().cpu())
           if rank == src else None]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(group or dist.group.WORLD, src),
        group=group, device=_comm_device(group))
    return _map_tensors(box[0], lambda t: t.to(device))


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(W * n, ...) from every rank's (n, ...), in group rank order."""
    w = dist.get_world_size(group)
    src = x.detach().to(_comm_device(group)).contiguous()
    out = src.new_empty((w * src.shape[0],) + tuple(src.shape[1:]))
    with _deprecated_ok():
        dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device)


def reduce_scatter_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's (n / W, ...) block of the sum over ranks of (n, ...)."""
    w = dist.get_world_size(group)
    if x.shape[0] % w:
        raise ValueError(f"{x.shape[0]} rows do not split over {w} ranks")
    src = x.detach().to(_comm_device(group)).contiguous()
    out = src.new_empty((src.shape[0] // w,) + tuple(src.shape[1:]))
    with _deprecated_ok():
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(x.device)


class AllGatherRows(torch.autograd.Function):
    """``AllGatherRows.apply(local, group, gathered=None)``: the row shards
    of every rank, concatenated; backward sums the gathered rows' gradient
    over ranks and hands each rank its own block. ``gathered``: the
    all-gather of ``local`` made already (forward then reuses it and
    communicates nothing)."""

    @staticmethod
    def forward(ctx, local, group, gathered: Optional[torch.Tensor] = None):
        ctx.group = group
        if gathered is None:
            gathered = all_gather_rows(local, group)
        return gathered.view_as(gathered)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_rows(grad, ctx.group), None, None
