"""Megatron tensor parallelism of the two-view ViT over a mesh's ``model``
axis (port of `starst3r_tpu/parallel/tp.py`).

The JAX package states the split as parameter PartitionSpecs and lets GSPMD
insert one psum per attention and per MLP. Here the same rules name the
port's modules, and `tp_shard_params` builds a copy of the network in which
each such block holds its rank's slice and all-reduces once:

  column-parallel (the output features split; torch weight (out, in) ->
  P(axis, None), bias P(axis)):
      attn.qkv, cross_attn.projq / projk / projv, mlp.fc1 and the
      descriptor head's fc1
  row-parallel (the input features split; weight P(None, axis); the bias
  replicated and added once, after the all-reduce):
      attn.proj, cross_attn.proj, mlp.fc2 and the descriptor head's fc2

The packed qkv's outputs are laid out [3, heads, hd] (models/vit.py), so a
contiguous split of its 3 dim features would give rank 0 all of q and part
of k; it is split as three column blocks instead, rank r holding heads
[r heads/m, (r+1) heads/m) of each of q, k and v, and its attention runs
those heads alone. A block whose heads (attention) or hidden width (MLP)
does not divide by the axis size stays replicated, both of its layers (the
JAX package replicates such a leaf and lets GSPMD reshard around it). The
matrix products stay ``nn.Linear``; the row-parallel sum is taken in
float32 and cast back to the activation dtype.

Composes with pair-parallel inference on a (data, model) mesh: the pair
batch is split over ``data`` (`Mast3rModel.infer_pairs(sharding=...)`)
while every rank of a ``model`` line runs the same pairs.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .comm import all_reduce
from .mesh import P, axis_group, axis_rank, axis_size

__all__ = ("tp_param_specs", "tp_shard_params", "RowParallelLinear")

# module-path suffixes, matched at a "." boundary; first hit wins
_COL = ("attn.qkv", "cross_attn.projq", "cross_attn.projk",
        "cross_attn.projv", "fc1")
_ROW = ("attn.proj", "cross_attn.proj", "fc2")


def _matches(path: str, pat: str) -> bool:
    return path == pat or path.endswith("." + pat)


def _spec_for(path: str, leaf: str, ndim: int, axis: str) -> P:
    for pat in _COL:
        if _matches(path, pat):
            if leaf == "weight" and ndim == 2:
                return P(axis, None)
            if leaf == "bias" and ndim == 1:
                return P(axis)
    for pat in _ROW:
        if _matches(path, pat) and leaf == "weight" and ndim == 2:
            return P(None, axis)
    return P()


def tp_param_specs(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                   axis: str = "model") -> Dict[str, P]:
    """{parameter name: its `P` spec} of the column/row split over mesh
    axis ``axis``, for a network, a `Mast3rModel` or a state dict."""
    net = getattr(params, "net", params)
    named = (dict(net.named_parameters()) if isinstance(net, nn.Module)
             else dict(net))
    out = {}
    for name, t in named.items():
        path, _, leaf = name.rpartition(".")
        out[name] = _spec_for(path, leaf, t.dim(), axis)
    return out


class RowParallelLinear(nn.Module):
    """The row-parallel half of a split ``nn.Linear``: this rank's columns
    of the weight on its block of the input features, the partial products
    summed over ``group`` (in float32), then the whole bias."""

    def __init__(self, lin: nn.Linear, lo: int, hi: int, group):
        super().__init__()
        self.weight = nn.Parameter(lin.weight.detach()[:, lo:hi].clone(),
                                   requires_grad=False)
        self.bias = (None if lin.bias is None else nn.Parameter(
            lin.bias.detach().clone(), requires_grad=False))
        self.group = group

    def forward(self, x):
        y = F.linear(x, self.weight)
        out = all_reduce(y.float(), self.group)
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(y.dtype)


def _column(lin: nn.Linear, rows: torch.Tensor) -> nn.Linear:
    """A Linear holding ``rows`` of ``lin``'s outputs."""
    out = nn.Linear(lin.in_features, len(rows), bias=lin.bias is not None,
                    device=lin.weight.device, dtype=lin.weight.dtype)
    with torch.no_grad():
        out.weight.copy_(lin.weight[rows])
        if lin.bias is not None:
            out.bias.copy_(lin.bias[rows])
    return out.requires_grad_(False)


def _shard_mlp(mlp, m: int, r: int, group) -> None:
    """fc1 column-parallel, fc2 row-parallel over an m-way split of the
    hidden width (``mlp`` is a vit.Mlp or the descriptor head)."""
    hid = mlp.fc1.out_features
    lo, hi = r * hid // m, (r + 1) * hid // m
    mlp.fc1 = _column(mlp.fc1, torch.arange(lo, hi))
    mlp.fc2 = RowParallelLinear(mlp.fc2, lo, hi, group)


def _head_rows(attn, m: int, r: int, blocks: int) -> torch.Tensor:
    """Output rows of heads [r H/m, (r+1) H/m) in each of ``blocks``
    consecutive [heads, hd] blocks."""
    dim = attn.heads * attn.head_dim
    lo = r * dim // m
    hi = (r + 1) * dim // m
    return torch.cat([torch.arange(b * dim + lo, b * dim + hi)
                      for b in range(blocks)])


def _shard_attention(attn, m: int, r: int, group) -> None:
    from ..models.vit import CrossAttention
    cols = _head_rows(attn, m, r, 1)
    if isinstance(attn, CrossAttention):
        attn.projq = _column(attn.projq, cols)
        attn.projk = _column(attn.projk, cols)
        attn.projv = _column(attn.projv, cols)
    else:
        attn.qkv = _column(attn.qkv, _head_rows(attn, m, r, 3))
    attn.proj = RowParallelLinear(attn.proj, int(cols[0]),
                                  int(cols[-1]) + 1, group)
    attn.heads //= m


def tp_shard_params(model, mesh, axis: str = "model"):
    """A tensor-parallel copy of ``model`` (a `Mast3rModel` or its
    `TwoViewNet`) for this rank of mesh axis ``axis``; every rank of the
    axis calls its forward with the same inputs. Blocks whose split does
    not divide the axis size stay replicated."""
    from ..models.heads import DescriptorHead
    from ..models.mast3r import Mast3rModel
    from ..models.vit import Attention, CrossAttention, Mlp
    m, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    group = axis_group(mesh, axis)
    net = copy.deepcopy(getattr(model, "net", model))
    if m > 1:
        for mod in list(net.modules()):
            if isinstance(mod, (Attention, CrossAttention)):
                if mod.heads % m == 0:
                    _shard_attention(mod, m, r, group)
            elif isinstance(mod, (Mlp, DescriptorHead)):
                if mod.fc1.out_features % m == 0:
                    _shard_mlp(mod, m, r, group)
    if not isinstance(model, Mast3rModel):
        return net
    from ..reconstruct import _model_tag
    out = Mast3rModel(model.cfg, net, model.device)
    # the pair cache keys on the whole model's weights, not this shard's
    out._tag = _model_tag(model)
    return out
